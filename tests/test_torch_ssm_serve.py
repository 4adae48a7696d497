"""Serving the SSM and hybrid families in the PyTorch port against the JAX
reference: the int8 state-slab engine (``launch/engines/ssm.py``) under
the family-blind scheduler, ``serve_dense`` for both families, the
dispatch and its refusals, and the CLI.

The rig is the reference's ``tests/test_engines.py::ssm_rig``:
Falcon-Mamba's smoke config in f32, ``PRNGKey(3)`` parameters bridged
from JAX, six 14-token prompts from ``np.random.default_rng(1)``, gens
``[10, 8, 10, 6, 10, 8]`` over 3 slots.  Greedy tokens are compared
exactly.  The int8 slabs are compared value by value: a slab entry may
sit on a rounding edge that the frameworks' f32 arithmetic moves by one
step, so up to 0.1% of them may differ by one (none did when this test
was written); the per-(layer, slot) scales within 1e-6 relative.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.launch.engines import SSMStateEngine as JSSMStateEngine
from repro.launch.faults import FaultPlan as JFaultPlan
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.launch import scheduler as tsched
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.engines import SSMStateEngine
from repro_torch.launch.faults import FaultPlan
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

SSM, HYBRID = "falcon_mamba_7b", "zamba2_2p7b"
GENS = [10, 8, 10, 6, 10, 8]


def _bridged(arch, seed):
    jcfg = jget_arch(arch).smoke.replace(dtype="float32")
    tcfg = tget_arch(arch).smoke.replace(dtype="float32")
    jparams = jax.device_get(jsteps.init_params_fn(jcfg)(
        jax.random.PRNGKey(seed)))
    return jcfg, jparams, tcfg, bridge.from_jax_params(jparams, tcfg,
                                                       device="cpu")


@pytest.fixture(scope="module")
def rig():
    jcfg, jparams, tcfg, tparams = _bridged(SSM, 3)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, 14, dtype=np.int32)
               for _ in range(6)]
    base = tserve.serve(tparams, tcfg, prompts, slots=3, gen=10, gens=GENS)
    assert len(base["finished"]) == 6
    return jcfg, jparams, tcfg, tparams, prompts, base


@pytest.fixture(scope="module")
def hybrid():
    return _bridged(HYBRID, 5)


def _reference_tokens(engine, prompt_count, gens):
    """The reference's no-scheduler greedy decode through a single-slot
    engine: each request admitted into slot 0 and stepped alone."""
    out = {}
    for rid in range(prompt_count):
        cache = engine.start_run()
        last1, cache = engine.admit(cache, 0, rid)
        toks = [int(torch.argmax(last1[0]))]
        tokens = torch.zeros((engine.slots,), dtype=torch.int64)
        tokens[0] = toks[0]
        while len(toks) < gens[rid]:
            logits, cache = engine.decode(tokens, cache)
            toks.append(int(torch.argmax(logits[0])))
            tokens[0] = toks[-1]
        engine.release(cache, 0)
        assert engine.leaked() == 0
        out[rid] = toks
    return out


# ------------------------------------------------- the engine's slabs --

def test_engine_slabs_equal_reference(rig):
    """Both engines after admissions into slots 0 and 2 (slot 1 idle, its
    slabs zero) and after 4 decode steps of all 3 slots: the int8 slabs
    equal (at most 0.1% of entries one step apart), the scales within
    1e-6, the logits within 1e-5 of their scale."""
    jcfg, jparams, tcfg, tparams, prompts, _ = rig
    jeng = JSSMStateEngine(jparams, jcfg, prompts, slots=3, max_len=40)
    teng = SSMStateEngine(tparams, tcfg, prompts, slots=3, max_len=40)
    jc, tc = jeng.start_run(), teng.start_run()
    for slot, rid in ((0, 0), (2, 1)):
        jl, jc = jeng.admit(jc, slot, rid)
        tl, tc = teng.admit(tc, slot, rid)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jl)).max())

    def compare(when, idle=()):
        for name in ("conv", "h"):
            got = tc[name + "_q"].numpy().astype(np.int32)
            want = np.asarray(jc["ssm_q"][name + "_q"]).astype(np.int32)
            off = np.abs(got - want)
            assert off.max() <= 1 and (off > 0).mean() <= 1e-3, (when, name)
            np.testing.assert_allclose(tc[name + "_s"].numpy(),
                                       np.asarray(jc["ssm_q"][name + "_s"]),
                                       rtol=1e-6, err_msg=when)
            for slot in idle:
                assert not tc[name + "_q"][:, slot].any()
        np.testing.assert_array_equal(tc["length"].numpy(),
                                      np.asarray(jc["length"]))

    compare("admitted", idle=(1,))
    tok = np.zeros(3, np.int32)
    for _ in range(4):
        jo, jc = jeng.decode(jnp.asarray(tok), jc)
        to, tc = teng.decode(torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jo)).max())
        tok = np.asarray(jnp.argmax(jo, -1)).astype(np.int32)
    compare("after 4 decode steps")
    assert teng.kv_bytes_per_step(GENS) == jeng.kv_bytes_per_step(GENS)


def test_engine_state_round_trip_is_idempotent(rig):
    """Requantizing a dequantized slab gives back its int8 values and its
    scales: a slot that keeps stepping without a request does not
    drift."""
    from repro_torch.launch.engines import ssm as essm
    _, _, tcfg, tparams, prompts, _ = rig
    eng = SSMStateEngine(tparams, tcfg, prompts, slots=3, max_len=40)
    _, cache = eng.admit(eng.start_run(), 1, 0)
    again = essm.quant_state(essm.dequant_state(cache, tcfg))
    for k, v in again.items():
        assert torch.equal(v[:, 1], cache[k][:, 1]), k


# ------------------------ the reference's tests/test_engines.py, SSM half --

def test_ssm_serve_matches_singleslot_engine(rig):
    _, _, tcfg, tparams, prompts, base = rig
    eng = SSMStateEngine(tparams, tcfg, prompts, slots=1, max_len=40)
    assert base["finished"] == _reference_tokens(eng, len(prompts), GENS)


def test_ssm_forced_preempt_resumes_bitwise(rig):
    """No pool to exhaust: the forced-preemption fault snapshots,
    re-queues, re-prefills and replays; the tokens do not move."""
    _, _, tcfg, tparams, prompts, base = rig
    stats = tserve.serve(tparams, tcfg, prompts, slots=3, gen=10, gens=GENS,
                         fault_plan=FaultPlan(preempt_step=3,
                                              preempt_slot=1))
    assert stats["preemptions"] == 1
    assert stats["resumes"] == 1
    assert stats["finished"] == base["finished"]
    assert stats["leaked_blocks"] == 0
    assert stats["slot_prefills"] == len(prompts) + 1


def test_ssm_retired_slot_state_does_not_drift(rig):
    _, _, tcfg, tparams, prompts, base = rig
    stats = tserve.serve(tparams, tcfg, prompts, slots=2, gen=10, gens=GENS)
    assert stats["finished"] == base["finished"]


def test_ssm_engine_refuses_a_pool(rig):
    _, _, tcfg, tparams, prompts, _ = rig
    with pytest.raises(ValueError, match="paged KV cache"):
        tserve.serve(tparams, tcfg, prompts, slots=2, gen=4, pool_blocks=8)
    with pytest.raises(ValueError, match="ssm family"):
        SSMStateEngine(tparams, tget_arch("tinyllama_1p1b").smoke, prompts,
                       slots=2, max_len=40)


# --------------------------------------------- the scheduler's repair --

def test_run_schedule_without_a_pool(rig):
    """An engine with ``alloc`` None: the scheduler skips every pool call
    (a pool-exhaust fault squeezes nothing), ``leaked_blocks`` is the
    engine's 0, and no pool is recorded; the health record's counters and
    the tokens are the reference's under the same plan."""
    jcfg, jparams, tcfg, tparams, prompts, base = rig
    eng = SSMStateEngine(tparams, tcfg, prompts, slots=3, max_len=40)
    assert eng.alloc is None
    plan = dict(exhaust_step=2, exhaust_hold=3, preempt_step=4,
                preempt_slot=0)
    stats = tsched.run_schedule(eng, prompts, gens=GENS,
                                fault_plan=FaultPlan(**plan), warmup=True)
    assert stats["finished"] == base["finished"]
    assert stats["leaked_blocks"] == 0
    assert stats["health"]["pools"] == {}
    assert stats["health"]["counters"]["admission_stalls"] == 0
    assert (stats["warmup_prefills"], stats["warmup_decode_steps"]) == (1, 1)
    jstats = jserve.serve(jparams, jcfg, prompts, slots=3, gen=10, gens=GENS,
                          fault_plan=JFaultPlan(**plan))
    assert stats["finished"] == jstats["finished"]
    assert stats["health"]["counters"] == jstats["health"]["counters"]
    assert stats["health"]["pools"] == jstats["health"]["pools"]


# -------------------------------------------- tokens against the JAX --

def test_paged_serve_tokens_equal_reference(rig):
    jcfg, jparams, _, _, prompts, base = rig
    want = jserve.serve(jparams, jcfg, prompts, slots=3, gen=10, gens=GENS)
    assert base["finished"] == want["finished"]
    assert base["decode_steps"] == want["decode_steps"]
    assert base["kv_bytes_per_step"] == want["kv_bytes_per_step"]


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_dense_serve_tokens_equal_reference(rig, hybrid, arch):
    """``serve_dense``, fused and composed: the reference's tokens, batch
    prefills and ``kv_bytes_per_step``, which counts ``n_layers`` attention
    layers of ``n_kv_heads x hd`` in both packages (ROADMAP queue 3) where
    the hybrid has one a group and Falcon-Mamba none."""
    if arch == SSM:
        jcfg, jparams, tcfg, tparams, prompts, _ = rig
        gens = GENS
    else:
        jcfg, jparams, tcfg, tparams = hybrid
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, tcfg.vocab_size, 12, dtype=np.int32)
                   for _ in range(5)]
        gens = [8, 5, 8, 6, 7]
    for fused in (True, False):
        kw = dict(slots=3, gen=10, gens=gens, cache_kind="dense")
        got = tserve.serve(tparams, tcfg.replace(attn_fused=fused), prompts,
                           **kw)
        want = jserve.serve(jparams, jcfg.replace(attn_fused=fused), prompts,
                            **kw)
        assert got["finished"] == want["finished"], fused
        assert got["batch_prefills"] == want["batch_prefills"] > 1
        assert got["kv_bytes_per_step"] == want["kv_bytes_per_step"]
    max_len = len(prompts[0]) + max(gens) + 8
    assert got["kv_bytes_per_step"] == (2 * tcfg.n_layers * 3
                                        * tcfg.n_kv_heads * max_len
                                        * tcfg.hd)


def test_serve_dense_feeds_padding_into_the_state(rig):
    """The reference's re-prefill runs every row at the batch's width: a
    row shorter than that continues from the state after its zero padding
    (``transformer.prefill``), in both packages alike.  Its last valid
    logits do not see the padding (a causal scan); its SSM state does."""
    jcfg, jparams, tcfg, tparams, _, _ = rig
    tok = np.random.default_rng(4).integers(0, tcfg.vocab_size, (1, 12)
                                            ).astype(np.int32)
    padded = tok.copy()
    padded[0, 7:] = 0
    lens = np.array([7], np.int32)
    states = {}
    for name, t, v in (("short", tok[:, :7], None), ("padded", padded, lens)):
        jlast, jc = JT.prefill(jparams, jnp.asarray(t), jcfg,
                               JT.make_cache(jcfg, 1, 24),
                               valid_len=None if v is None else
                               jnp.asarray(v))
        tlast, tc = TT.prefill(tparams, torch.from_numpy(t), tcfg,
                               TT.make_cache(tcfg, 1, 24, device="cpu"),
                               valid_len=None if v is None else
                               torch.from_numpy(v))
        np.testing.assert_allclose(tc["h"].numpy(), np.asarray(jc["ssm"]["h"]),
                                   rtol=0, atol=1e-5 * np.abs(
                                       np.asarray(jc["ssm"]["h"])).max())
        states[name] = (tlast, tc["h"], np.asarray(jlast),
                        np.asarray(jc["ssm"]["h"]))
    short, pad = states["short"], states["padded"]
    np.testing.assert_allclose(pad[0].numpy(), short[0].numpy(), rtol=0,
                               atol=1e-5 * np.abs(short[2]).max())
    for got, want in ((pad[1].numpy(), short[1].numpy()), (pad[3], short[3])):
        assert np.abs(got - want).max() > 1e-2 * np.abs(want).max()


# --------------------------------------------------- family dispatch --

def test_dispatch_and_refusals(rig, hybrid):
    _, _, tcfg, tparams, prompts, _ = rig
    jcfg_h, jparams_h, tcfg_h, tparams_h = hybrid
    assert isinstance(tserve.make_engine(tparams, tcfg, prompts, slots=2,
                                         max_len=40), SSMStateEngine)
    for serve, cfg, params in ((tserve.serve, tcfg_h, tparams_h),
                               (jserve.serve, jcfg_h, jparams_h)):
        with pytest.raises(ValueError, match="no cache engine"):
            serve(params, cfg, prompts, slots=2, gen=4)
    for cfg, params in ((tcfg, tparams), (tcfg_h, tparams_h)):
        with pytest.raises(ValueError, match="decoder-only"):
            tserve.serve(params, cfg, prompts, slots=2, gen=4, draft="self")
        for make in (tsteps.make_verify_step, tsteps.make_draft_loop):
            with pytest.raises(ValueError, match="decoder-only"):
                make(cfg, *([4] if make is tsteps.make_draft_loop else []))
    # training the family, refused until the slice that trains every
    # family, now runs (tests/test_torch_train_families.py)
    rec = ttrain.main(["--arch", SSM, "--smoke", "--device", "cpu", "--steps",
                       "1", "--batch", "2", "--seq", "8"])
    assert np.isfinite(rec["losses"]).all() and rec["cfg"].family == "ssm"


# ------------------------------------------------------------ the CLI --

@pytest.mark.parametrize("arch,flags", [
    (SSM, ["--requests", "6", "--slots", "3", "--prompt-len", "14",
           "--gen", "10"]),
    (SSM, ["--requests", "6", "--slots", "3", "--prompt-len", "14",
           "--gen", "10", "--cache", "dense"]),
    (HYBRID, ["--cache", "dense"]),
])
def test_cli_smoke_tokens_equal_reference_cli(monkeypatch, arch, flags):
    """Both CLIs on the same flags; the port's ``init_params`` hands out the
    reference CLI's parameters (``PRNGKey(seed)``), bridged."""
    argv = ["--arch", arch, "--smoke"] + flags
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jserve.main(argv)
    want = out.getvalue()

    def reference_params(cfg, *, seed, device, serving):
        assert serving and cfg.name == jget_arch(arch).smoke.name
        jcfg = jget_arch(arch).smoke.replace(dtype="float32")
        return bridge.from_jax_params(jax.device_get(
            jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(seed))), cfg,
            device=device)

    monkeypatch.setattr(TT, "init_params", reference_params)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(argv + ["--device", "cpu"])
    got = out.getvalue()
    family = tget_arch(arch).smoke.family
    cache = "dense" if "dense" in flags else "paged"
    assert f"[{cache}:{family}:cpu] served" in got
    assert "0 leaked blocks" in got

    def req_lines(text):
        return [ln for ln in text.splitlines() if ln.startswith("  req ")]

    assert len(req_lines(want)) == (6 if arch == SSM else 8)
    assert req_lines(got) == req_lines(want)
