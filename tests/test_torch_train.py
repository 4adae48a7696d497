"""The QAT trainer of the PyTorch port against the JAX reference on the
TinyLlama smoke config in float32: the loss, one train step (loss, every
leaf's gradient, lr, grad_norm), ten steps' losses, the compressed and the
gradient-accumulation steps, from parameters bridged from
``repro.launch.steps.init_params_fn`` on the reference's own batches; then
the CLI's resume (``python -m repro_torch.launch.train``) and the mirror of
``tests/test_system.py``: a fakequant-trained model served through the int8
datapath.

Tolerances (the two frameworks' f32 matmuls, exp and reductions differ in
the last bits, and a last-bit difference of a score on a rounding edge
moves its int8 grid index, see ``test_torch_split_softmax.py``): one step's
loss rtol 1e-5, each gradient leaf within 1e-4 of its largest magnitude
(measured ~2e-6), lr and grad_norm rtol 1e-5; ten steps' losses and grad
norms rtol 1e-3 (the drift compounds; measured 4e-5).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import batch_for_step as jbatch_for_step
from repro.dist import compression as jcomp
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch import tree as tu
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.dist import compression as comp
from repro_torch.launch import steps as st
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
OPT = dict(peak_lr=1e-3, warmup_steps=5, total_steps=30)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(0))
    dc = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4,
                     seed=3)
    batches = [jax.device_get(jbatch_for_step(dc, i)) for i in range(10)]
    return jcfg, tcfg, jparams, batches


def _tparams(jparams, tcfg):
    return bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                  device="cpu")


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaf_close(got_tree, want_tree, tol=1e-4):
    """Every leaf of the port's tree (its layout) within ``tol`` of the
    largest magnitude of the reference's leaf (JAX layout)."""
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(want_tree))[0]
    got = jax.tree.leaves(bridge.to_jax_layout(got_tree))
    assert len(got) == len(flat)
    for (path, want), g in zip(flat, got):
        want = np.asarray(want)
        err = float(np.abs(g - want).max())
        assert err <= tol * float(np.abs(want).max()), \
            (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------- loss ----

@pytest.mark.parametrize("vocab,vp", [(500, 512), (300, 512), (512, 512)])
def test_cross_entropy_equal_jax(rng, vocab, vp):
    logits = rng.normal(0, 3, (2, 7, vp)).astype(np.float32)
    logits[..., vocab:] += 50.0              # padding lanes must not count
    labels = rng.integers(0, vocab, (2, 7)).astype(np.int32)
    want = float(jsteps.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels), vocab))
    got = st.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_loss_fn_forward_equal_jax(setup):
    jcfg, tcfg, jparams, batches = setup
    jl, jm = jsteps.loss_fn(jparams, batches[0], jcfg)
    tl, tm = st.loss_fn(_tparams(jparams, tcfg), _tb(batches[0]), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tm["aux_loss"]) == float(tm["z_loss"]) == 0.0
    assert float(tm["ce"]) == float(tl)


# ----------------------------------------------------------- one step ----

def test_one_train_step_equal_jax(setup):
    jcfg, tcfg, jparams, batches = setup
    (jl, _), jg = jax.value_and_grad(jsteps.loss_fn, has_aux=True)(
        jparams, batches[0], jcfg)
    tparams = _tparams(jparams, tcfg)
    (tl, _), tg = st.value_and_grad(tparams, _tb(batches[0]), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _leaf_close(tg, jg)

    jstep = jax.jit(jsteps.make_train_step(jcfg,
                                           jadamw.OptimizerConfig(**OPT)))
    jp, js, jm = jstep(jparams, jadamw.init_state(jparams), batches[0])
    tstep = st.make_train_step(tcfg, adamw.OptimizerConfig(**OPT))
    tp, ts, tm = tstep(tparams, adamw.init_state(tparams), _tb(batches[0]))
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
    assert int(ts.step) == 1
    _leaf_close(tp, jp)
    _leaf_close(ts.mu, js.mu)
    _leaf_close(ts.nu, js.nu)


def test_ten_steps_losses_equal_jax(setup):
    jcfg, tcfg, jparams, batches = setup
    jstep = jax.jit(jsteps.make_train_step(jcfg,
                                           jadamw.OptimizerConfig(**OPT)))
    tstep = st.make_train_step(tcfg, adamw.OptimizerConfig(**OPT))
    jp, js = jparams, jadamw.init_state(jparams)
    tp = _tparams(jparams, tcfg)
    ts = adamw.init_state(tp)
    jl, tl, jn, tn = [], [], [], []
    for b in batches:
        jp, js, jm = jstep(jp, js, b)
        tp, ts, tm = tstep(tp, ts, _tb(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        jn.append(float(jm["grad_norm"]))
        tn.append(float(tm["grad_norm"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    np.testing.assert_allclose(tn, jn, rtol=1e-3)
    assert tl[-1] < tl[0]


def test_compressed_train_step_equal_jax(setup):
    """Two compressed steps: loss, lr and grad_norm each step; the
    parameters after the first.  A gradient's last-bit difference on an
    int8 rounding edge moves its payload by one step, and Adam turns a
    moved element into an update of up to ~lr: every element is within
    3 lr, and at most 1% of a leaf's elements is off by more than 1e-4 of
    its scale.  (From the second step on such moved elements perturb every
    gradient, so the elementwise check stops at one step.)"""
    jcfg, tcfg, jparams, batches = setup
    jstep = jax.jit(jsteps.make_compressed_train_step(
        jcfg, jadamw.OptimizerConfig(**OPT)))
    tstep = st.make_compressed_train_step(tcfg, adamw.OptimizerConfig(**OPT))
    jp, js, je = jparams, jadamw.init_state(jparams), jcomp.init_error(jparams)
    tp = _tparams(jparams, tcfg)
    ts, te = adamw.init_state(tp), comp.init_error(tp)
    for i, b in enumerate(batches[:2]):
        jp, js, je, jm = jstep(jp, js, je, b)
        tp, ts, te, tm = tstep(tp, ts, te, _tb(b))
        for key, tol in (("loss", 1e-5), ("lr", 1e-5), ("grad_norm", 1e-3)):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=tol)
        if i:
            continue
        lr = float(jm["lr"])
        flat = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
        for (path, want), got in zip(flat, jax.tree.leaves(
                bridge.to_jax_layout(tp))):
            diff = np.abs(got - np.asarray(want))
            key = jax.tree_util.keystr(path)
            assert diff.max() <= 3 * lr, (key, diff.max())
            off = np.mean(diff > 1e-4 * np.abs(want).max())
            assert off <= 0.01, (key, off)
    for g in tu.leaves(te):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_grad_accum_train_step_equal_jax(setup):
    jcfg, tcfg, jparams, batches = setup
    opt = dict(OPT, accum_steps=2)
    stacked = {k: np.stack([b[k][:2], b[k][2:]]) for k, b in
               ((k, batches[0]) for k in ("tokens", "labels"))}
    jp, js, jm = jax.jit(jsteps.make_grad_accum_train_step(
        jcfg, jadamw.OptimizerConfig(**opt)))(
            jparams, jadamw.init_state(jparams), stacked)
    tp = _tparams(jparams, tcfg)
    tp, ts, tm = st.make_grad_accum_train_step(
        tcfg, adamw.OptimizerConfig(**opt))(tp, adamw.init_state(tp),
                                            _tb(stacked))
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
    _leaf_close(tp, jp)


def test_train_step_is_deterministic(setup):
    """The same state and batch twice: loss, grads and parameters equal
    bit for bit (no atomics; the embedding's backward is a GEMM)."""
    _, tcfg, jparams, batches = setup
    outs = []
    for _ in range(2):
        tp = _tparams(jparams, tcfg)
        (loss, _), g = st.value_and_grad(tp, _tb(batches[1]), tcfg)
        tp, _, _ = st.make_train_step(tcfg, adamw.OptimizerConfig(**OPT))(
            tp, adamw.init_state(tp), _tb(batches[1]))
        outs.append((loss, g, tp))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tu.leaves(outs[0][1:]), tu.leaves(outs[1][1:])):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- CLI ----

_STEP = re.compile(r"^step\s+(\d+) loss (\S+) ce (\S+) lr (\S+) gnorm (\S+)$",
                   re.M)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--batch", "4", "--seq", "32", "--log-every",
         "1", *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_cli_resumes_exactly(tmp_path):
    """6 steps straight against 3, a checkpoint, and a second run that
    resumes and takes 3 more: the same log lines and the same final
    checkpoint, bit for bit (the first 6 steps are warmup, so the schedule
    does not depend on --steps)."""
    straight = _cli("--steps", "6", "--ckpt-dir", str(tmp_path / "a"))
    first = _cli("--steps", "3", "--ckpt-dir", str(tmp_path / "b"))
    second = _cli("--steps", "6", "--ckpt-dir", str(tmp_path / "b"))
    assert "resumed from step 3" in second
    assert "resumed" not in first
    lines = {m.group(1): m.group(0) for m in _STEP.finditer(straight)}
    got = {m.group(1): m.group(0) for m in _STEP.finditer(first + second)}
    assert sorted(lines, key=int) == [str(i) for i in range(1, 7)]
    assert got == lines
    cfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    like = train._ckpt_tree(params, adamw.init_state(params))
    _, a, _ = CheckpointManager(str(tmp_path / "a")).restore(6, like)
    _, b, _ = CheckpointManager(str(tmp_path / "b")).restore(6, like)
    for x, y in zip(tu.leaves(a), tu.leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert int(b[1].step) == 6


def test_cli_compressed_and_main_record(capsys):
    rec = train.main(["--smoke", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--compress-grads",
                      "--log-every", "2"])
    out = capsys.readouterr().out
    assert [m.group(1) for m in _STEP.finditer(out)] == ["1", "2"]
    assert "done: 3 steps" in out
    assert len(rec["losses"]) == len(rec["step_s"]) == 3
    assert all(np.isfinite(rec["losses"])) and rec["start_step"] == 0
    assert int(rec["opt_state"].step) == 3


# -------------------------------------------------- fakequant -> int8 ----

def test_fakequant_trained_model_serves_int8():
    """The mirror of ``tests/test_system.py``: 30 QAT steps on the port, then
    the teacher-forced logits of the training forward (fakequant) and of
    the int8 datapath agree, at the reference's thresholds."""
    cfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=48, global_batch=8,
                    seed=11)
    params = st.init_params_fn(cfg)(seed=0, device="cpu")
    opt_state = adamw.init_state(params)
    step = st.make_train_step(cfg, adamw.OptimizerConfig(**OPT))
    losses = []
    for i in range(30):
        params, opt_state, m = step(params, opt_state, batch_for_step(dc, i))
        losses.append(float(m["loss"]))
    tok = batch_for_step(dc, 100)["tokens"][:, :32]
    with torch.no_grad():
        logits_fq, _ = T.forward(params, tok, cfg)
        logits_i8, _ = T.forward(params, tok, cfg.replace(attn_mode="int8"))
    p_fq = torch.softmax(logits_fq[..., :cfg.vocab_size], -1)
    p_i8 = torch.softmax(logits_i8[..., :cfg.vocab_size], -1)
    agree = float((p_fq.argmax(-1) == p_i8.argmax(-1)).float().mean())
    assert agree > 0.9, agree
    tv = 0.5 * float((p_fq - p_i8).abs().sum(-1).mean())
    assert tv < 0.1, tv
    assert losses[-1] < losses[0]


def test_attn_spec_modes_and_serve_call_sites():
    """Training asks for ``attn_mode`` (fakequant), every serve step for
    ``serve_attn_mode`` (int8); the decode entry points' fakequant mode is
    the float baseline over the dequantized cache, not the int8 path."""
    from repro_torch.core import attention as core_attn
    cfg = get_arch("tinyllama_1p1b").smoke
    assert cfg.attn_spec().mode == "fakequant"
    assert cfg.attn_spec(serve=True).mode == "int8"
    assert cfg.replace(serve_attn_mode="float").attn_spec(
        serve=True).mode == "float"
    with pytest.raises(ValueError):
        core_attn.AttentionSpec(mode="fp8")
    q = torch.randn(2, 8, 16)
    cache = torch.randint(-128, 128, (2, 2, 8, 16), dtype=torch.int8)
    outs = {mode: core_attn.decode_attention(
        q, cache, cache, torch.tensor(0.1), torch.tensor(0.1),
        torch.tensor([1, 2]), core_attn.AttentionSpec(mode=mode))
        for mode in ("fakequant", "float", "int8")}
    assert torch.equal(outs["fakequant"], outs["float"])
    assert not torch.equal(outs["fakequant"], outs["int8"])
    # a serve-mode config whose serve steps asked for the training spec
    # would run fakequant float attention: the prefill's logits tell
    tcfg = cfg.replace(dtype="float32")
    params = T.init_params(tcfg, seed=0, device="cpu")
    tok = torch.randint(0, tcfg.vocab_size, (1, 12))
    with torch.no_grad():
        serve, _ = T.forward(params, tok, tcfg, serve=True)
        as_int8, _ = T.forward(params, tok, tcfg.replace(attn_mode="int8"))
        as_fq, _ = T.forward(params, tok, tcfg)
    assert torch.equal(serve, as_int8) and not torch.equal(serve, as_fq)
