"""The training substrate of the PyTorch port against the JAX reference,
mirroring ``tests/test_substrate.py``: the data pipeline, AdamW (its state,
schedule, clipping and decay set), checkpoints (and their crossing between
the two packages, both ways), the MessagePack codec against the
``msgpack`` package and error-feedback compression.  Inputs are drawn with
numpy and passed to both packages.

Tolerances: AdamW state, parameters and the learning rate rtol 1e-6
(torch's and XLA's f32 pow, sqrt and cos may differ in the last bits; the
warmup's learning rate is bit-equal).
The compression payload is bit-equal.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_arch as jget_arch
from repro.dist import compression as jcomp
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch import tree as tu
from repro_torch.checkpoint import codec
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, batch_for_step, token_stream
from repro_torch.dist import compression as comp
from repro_torch.optim import adamw

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------- data ---------------------------------------

def test_data_deterministic():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=8, seed=7)
    a, b = batch_for_step(cfg, 3), batch_for_step(cfg, 3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int32
    assert not torch.equal(a["tokens"], batch_for_step(cfg, 4)["tokens"])
    other = DataConfig(vocab_size=100, seq_len=32, global_batch=8, seed=8)
    assert not torch.equal(a["tokens"], batch_for_step(other, 3)["tokens"])
    step, c = next(token_stream(cfg, start_step=3))
    assert step == 3 and torch.equal(c["tokens"], a["tokens"])


def test_data_labels_are_shifted_with_wrap():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=2)
    b = batch_for_step(cfg, 0)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert torch.equal(b["labels"][:, -1], b["tokens"][:, 0])


def test_data_host_sharding_disjoint():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=8)
    h0 = batch_for_step(cfg, 0, host_index=0, host_count=2)
    h1 = batch_for_step(cfg, 0, host_index=1, host_count=2)
    assert h0["tokens"].shape == (4, 8)
    assert not torch.equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError):
        batch_for_step(cfg, 0, host_count=3)


@pytest.mark.parametrize("vocab", [160, 512, 7])
def test_data_in_vocab_and_banded(vocab):
    cfg = DataConfig(vocab_size=vocab, seq_len=64, global_batch=4)
    tok = batch_for_step(cfg, 1)["tokens"].numpy()
    assert tok.min() >= 0 and tok.max() < vocab


def test_data_has_learnable_structure():
    """P(band_{t+1} | band_t) is far from uniform, as in the reference."""
    cfg = DataConfig(vocab_size=160, seq_len=512, global_batch=8, n_latent=16)
    bands = batch_for_step(cfg, 0)["tokens"].numpy() // 10
    nl = 16
    counts = np.zeros((nl, nl))
    np.add.at(counts, (bands[:, :-1].ravel(), bands[:, 1:].ravel()), 1)
    rows = counts.sum(1, keepdims=True)
    p = counts / np.maximum(rows, 1)
    live = rows[:, 0] > 50
    kl = np.where(p > 0, p * np.log(np.maximum(p, 1e-12) * nl), 0).sum(1)
    assert kl[live].mean() > 0.2, kl[live].mean()


# ------------------------------ optimizer -----------------------------------

def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.OptimizerConfig(peak_lr=0.3, warmup_steps=5, total_steps=300,
                                weight_decay=0.0, clip_norm=10.0)
    state = adamw.init_state(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"].clone()}
        params, state, _ = adamw.apply_updates(params, grads, state, opt)
    assert float(params["w"].abs().max()) < 1e-2


def test_lr_schedule_shape():
    opt = adamw.OptimizerConfig(peak_lr=1.0, warmup_steps=10,
                                total_steps=100, min_lr_ratio=0.1)
    assert float(adamw.lr_at(opt, 0)) == 0.0
    assert abs(float(adamw.lr_at(opt, 10)) - 1.0) < 1e-6
    assert abs(float(adamw.lr_at(opt, 100)) - 0.1) < 1e-6


def test_lr_schedule_equal_jax():
    for opt in (adamw.OptimizerConfig(peak_lr=3e-4, warmup_steps=20,
                                      total_steps=100),
                adamw.OptimizerConfig(peak_lr=1e-3, warmup_steps=5,
                                      total_steps=30)):
        jopt = jadamw.OptimizerConfig(peak_lr=opt.peak_lr,
                                      warmup_steps=opt.warmup_steps,
                                      total_steps=opt.total_steps)
        for step in list(range(0, 40)) + [99, 100, 150]:
            got = adamw.lr_at(opt, step)
            want = np.float32(jadamw.lr_at(jopt, jnp.int32(step)))
            assert got.dtype == torch.float32
            if step < opt.warmup_steps:
                assert float(got) == float(want), (step, got, want)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-6


def _opt_tree(rng):
    return {"embed": {"table": rng.normal(0, 1, (16, 8))},
            "final_norm": {"scale": 1 + rng.normal(0, 0.1, (8,))},
            "w_big": {"w": rng.normal(0, 3, (8, 12))},
            "layers": [{"norm1": {"scale": 1 + rng.normal(0, 0.1, (8,))},
                        "mlp": {"w_in": {"w": rng.normal(0, 1, (8, 4))}}}]}


def test_apply_updates_equal_jax(rng):
    """Three AdamW steps on the same tree and gradients (clipping active
    on the first): parameters, moments, step, lr and grad_norm."""
    tree = tu.tree_map(lambda a: np.asarray(a, np.float32), _opt_tree(rng))
    grads = [tu.tree_map(lambda a: rng.normal(0, s, a.shape).astype(
        np.float32), tree) for s in (2.0, 0.1, 0.01)]
    opt = adamw.OptimizerConfig(peak_lr=1e-2, warmup_steps=2, total_steps=5)
    jopt = jadamw.OptimizerConfig(peak_lr=1e-2, warmup_steps=2,
                                  total_steps=5)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jadamw.init_state(jp)
    tp = tu.tree_map(_t, tree)
    ts = adamw.init_state(tp)
    for g in grads:
        jp, js, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                          js, jopt)
        tp, ts, tm = adamw.apply_updates(tp, tu.tree_map(_t, g), ts, opt)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for gl, wl in zip(tu.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                       rtol=1e-6, atol=1e-9)


def test_decay_set_equal_jax_leaf_by_leaf():
    """The port decides weight decay from its own paths; on TinyLlama it
    takes the reference's decision for every leaf: every ``w`` and the
    embedding table decay, the norm scales do not."""
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jparams = jax.device_get(jsteps.init_params_fn(jcfg)(
        jax.random.PRNGKey(0)))
    jdecay = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = "/".join(str(p) for p in path)
        jdecay[key] = jadamw._is_decayed(str(path))
    tparams = bridge.from_jax_params(jparams, tcfg, device="cpu")
    seen = set()
    for path, _ in tu.leaves_with_path(tparams):
        if path[0][1] == "layers":            # layer i -> the stacked segment
            jpath = (("key", "segments"), ("idx", 0)) + path[2:]
        else:
            jpath = path
        key = tu.keystr(jpath)
        mine = adamw._is_decayed(tu.pathstr(path))
        assert mine == jdecay[key], (tu.pathstr(path), key)
        assert mine == (path[-1][1] in ("w", "table")), key
        seen.add(key)
    assert seen == set(jdecay) and len(seen) == 12


# ------------------------------ checkpoint ----------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": np.arange(6).reshape(2, 3).astype(np.float32),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    mgr.save(5, tree, extra={"seed": 1})
    step, restored, extra = mgr.restore(None, tree)
    assert step == 5 and extra["seed"] == 1
    np.testing.assert_array_equal(restored["a"], tree["a"])
    np.testing.assert_array_equal(restored["b"]["c"], [1, 2, 3])


def test_checkpoint_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": np.zeros(3, np.float32)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.latest_step() == 4
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_3", "step_4"]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_async_snapshots_now(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.arange(4, dtype=torch.float32)
    mgr.save_async(7, {"x": x})
    x.add_(100)                       # an in-place update after the snapshot
    mgr.wait()
    step, restored, _ = mgr.restore(None, {"x": x})
    assert step == 7
    np.testing.assert_array_equal(restored["x"], np.arange(4, dtype=np.float32))


def test_checkpoint_restore_by_path_not_order(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"b": np.ones(2, np.float32), "a": np.zeros(3, np.float32)}
    mgr.save(1, tree)
    like = {"a": np.empty(3, np.float32), "b": np.empty(2, np.float32)}
    _, restored, _ = mgr.restore(None, like)
    np.testing.assert_array_equal(restored["a"], tree["a"])
    np.testing.assert_array_equal(restored["b"], tree["b"])


def test_checkpoint_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(None, {})


@pytest.fixture(scope="module")
def smoke_state():
    """JAX's smoke parameters and a 3-step optimizer state (numpy), and
    their port twins."""
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jp = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(1))
    js = jadamw.init_state(jp)
    opt = jadamw.OptimizerConfig()
    rng = np.random.default_rng(5)
    for _ in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(rng.normal(
            0, 1e-2, a.shape), jnp.float32), jp)
        jp, js, _ = jadamw.apply_updates(jp, g, js, opt)
    jp, js = jax.device_get((jp, js))
    return (jp, js, bridge.from_jax_params(jp, tcfg, device="cpu"),
            bridge.from_jax_opt_state(js, tcfg, device="cpu"), tcfg)


def _port_tree(tp, ts):
    return (bridge.to_jax_layout(tp),
            adamw.OptState(step=ts.step, mu=bridge.to_jax_layout(ts.mu),
                           nu=bridge.to_jax_layout(ts.nu)))


def test_checkpoint_port_writes_reference_restores(tmp_path, smoke_state):
    jp, js, tp, ts, _ = smoke_state
    CheckpointManager(str(tmp_path)).save(3, _port_tree(tp, ts),
                                          extra={"seed": 0})
    step, (rp, rs), extra = JManager(str(tmp_path)).restore(None, (jp, js))
    assert step == 3 and extra == {"seed": 0}
    flat_j = jax.tree_util.tree_flatten_with_path((jp, js))[0]
    assert len(flat_j) == 37
    for (path, want), got in zip(flat_j, jax.tree.leaves((rp, rs))):
        assert got.dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got, want)


def test_checkpoint_reference_writes_port_restores(tmp_path, smoke_state):
    jp, js, tp, ts, tcfg = smoke_state
    JManager(str(tmp_path)).save(3, (jp, js), extra={"final": True})
    with open(tmp_path / "step_3" / "index.msgpack", "rb") as f:
        keys = set(msgpack.unpackb(f.read())["arrays"])
    assert "[0]/['segments']/[0]/['attn']/['wq']/['w']" in keys
    assert "[1]/.step" in keys and "[1]/.mu/['embed']/['table']" in keys
    like = _port_tree(tp, ts)
    assert {tu.keystr(p) for p, _ in tu.leaves_with_path(like)} == keys
    step, (rp, rs), extra = CheckpointManager(str(tmp_path)).restore(
        None, like)
    assert step == 3 and extra == {"final": True}
    rp = bridge.from_jax_params(rp, tcfg, device="cpu")
    rs = bridge.from_jax_opt_state(rs, tcfg, device="cpu")
    assert int(rs.step) == 3 and rs.step.dtype == torch.int32
    for got, want in zip(tu.leaves((rp, rs)), tu.leaves((tp, ts))):
        assert torch.equal(got, want)


# ------------------------------- codec --------------------------------------

CODEC_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -1.5, 1e300, float("inf"), "", "a" * 31,
    "b" * 32, "c" * 255, "d" * 256, "e" * 65536, "tëxt", [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)},
    {"step": 3, "extra": {"seed": 0, "final": True},
     "arrays": {"[1]/.step": {"file": "a0.npy", "shape": [],
                              "dtype": "int32", "shard_of": None}}},
]


@pytest.mark.parametrize("i", range(len(CODEC_CASES)))
def test_codec_equals_msgpack_both_ways(i):
    obj = CODEC_CASES[i]
    packed = codec.packb(obj)
    assert packed == msgpack.packb(obj)
    assert msgpack.unpackb(packed) == obj
    assert codec.unpackb(msgpack.packb(obj)) == obj


def test_codec_reads_tuples_as_lists_and_rejects_junk():
    assert codec.unpackb(msgpack.packb((1, (2, 3)))) == [1, [2, 3]]
    assert codec.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb([1, 2])[:-1])
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb(b"bytes"))
    with pytest.raises(TypeError):
        codec.packb(b"bytes")


# ----------------------------- compression ----------------------------------

def test_error_feedback_invariant(rng):
    g = {"w": _t(rng.normal(0, 1, (64,)).astype(np.float32))}
    e = comp.init_error(g)
    q, s, e2 = comp.compress(g, e)
    recon = comp.decompress(q, s)
    np.testing.assert_allclose((g["w"] + e["w"]).numpy(),
                               (recon["w"] + e2["w"]).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_compress_bit_equal_jax(rng):
    g = {"a": rng.normal(0, 1, (33,)).astype(np.float32),
         "b": [rng.normal(0, 1e-3, (4, 5)).astype(np.float32)]}
    e = {"a": rng.normal(0, 1e-2, (33,)).astype(np.float32),
         "b": [rng.normal(0, 1e-5, (4, 5)).astype(np.float32)]}
    jq, js, je = jcomp.compress(jax.tree.map(jnp.asarray, g),
                                jax.tree.map(jnp.asarray, e))
    tq, ts, te = comp.compress(tu.tree_map(_t, g), tu.tree_map(_t, e))
    for got, want in ((tq, jq), (ts, js), (te, je)):
        for gl, wl in zip(tu.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    jr, je2 = jcomp.compressed_psum(jax.tree.map(jnp.asarray, g),
                                    jax.tree.map(jnp.asarray, e), None)
    tr, te2 = comp.compressed_psum(tu.tree_map(_t, g), tu.tree_map(_t, e),
                                   None)
    for gl, wl in zip(tu.leaves((tr, te2)), jax.tree.leaves((jr, je2))):
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_compressed_sgd_converges():
    w = torch.tensor([4.0, -2.0, 1.0])
    err = {"w": torch.zeros(3)}
    for _ in range(400):
        red, err = comp.compressed_psum({"w": 2 * w}, err, axis_name=None)
        w = w - 0.01 * red["w"]
    assert float(w.abs().max()) < 1e-2


def test_compressed_psum_over_a_group_waits():
    """A named axis is a dim of the bound mesh: without a binding it is
    refused (the group path itself: tests/test_torch_sharding.py)."""
    with pytest.raises(ValueError, match="no mesh is bound"):
        comp.compressed_psum({"w": torch.ones(2)}, {"w": torch.zeros(2)},
                             axis_name="dp")
