"""Encoder-decoder serving of the PyTorch port against the JAX reference:
``EncDecEngine`` (the paged self-KV pool with its carved, write-once
cross-KV bank) under the family-blind scheduler, ``serve`` and the CLI, on
SeamlessM4T-medium's smoke config in float32.

The rig is the reference's ``encdec_rig`` (``tests/test_engines.py``):
parameters from ``PRNGKey(4)`` bridged to the port, six 12-token prompts
and six 12-frame encoder inputs from ``np.random.default_rng(2)``, gens
[8, 6, 8, 5, 8, 6], 3 slots, ``block_k`` 8.  Greedy tokens, scheduling
counts and preemptions equal the reference's exactly; the port's own
invariants (multi-slot serving equals a single-slot engine, preemption
resumes bitwise, the carved bank is neither live nor leaked) are the
reference's engine tests.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.launch.engines import EncDecEngine as JEngine
from repro.launch.faults import FaultPlan as JFaultPlan
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import paged_kv
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.engines import EncDecEngine
from repro_torch.launch.faults import FaultPlan
from repro_torch.launch.scheduler import run_schedule
from repro_torch.models import encdec as TE

torch.set_num_threads(1)

ARCH = "seamless_m4t_medium"
KW = dict(slots=3, gen=8, cache_kind="paged", block_k=8)


@pytest.fixture(scope="module")
def encdec_rig():
    jcfg = jget_arch(ARCH).smoke.replace(dtype="float32")
    tcfg = tget_arch(ARCH).smoke.replace(dtype="float32")
    jparams = jax.device_get(jsteps.init_params_fn(jcfg)(
        jax.random.PRNGKey(4)))
    tparams = bridge.from_jax_params(jparams, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab_size, 12, dtype=np.int32)
               for _ in range(6)]
    frames = [np.asarray(rng.normal(size=(12, jcfg.d_model)),
                         np.float32) * 0.02 for _ in range(6)]
    gens = [8, 6, 8, 5, 8, 6]
    want = jserve.serve(jparams, jcfg, prompts, gens=gens, frames=frames,
                        **KW)
    base = tserve.serve(tparams, tcfg, prompts, gens=gens, frames=frames,
                        **KW)
    assert len(base["finished"]) == 6
    return jcfg, jparams, tcfg, tparams, prompts, frames, gens, want, base


def test_serve_tokens_equal_reference(encdec_rig):
    *_, gens, want, base = encdec_rig
    assert base["finished"] == want["finished"]
    for key in ("served", "decode_steps", "slot_prefills", "total_tokens",
                "kv_bytes_per_step"):
        assert base[key] == want[key], key
    assert base["leaked_blocks"] == 0
    assert [len(base["finished"][r]) for r in range(6)] == gens


def _single_slot_tokens(engine, n, gens):
    """The reference's ``_reference_tokens``: each request admitted alone
    into slot 0 of a one-slot engine and stepped greedily to its end, after
    request 0 has calibrated the pool's scales."""
    out = {}
    for rid in range(n):
        cache = engine.start_run()
        if rid != 0:
            _, cache = engine.admit(cache, 0, 0)
            cache = engine.release(cache, 0)
        last1, cache = engine.admit(cache, 0, rid)
        toks = [int(torch.argmax(last1[0]))]
        tokens = torch.zeros((engine.slots,), dtype=torch.int64)
        tokens[0] = toks[0]
        while len(toks) < gens[rid]:
            upto = len(engine.prompts[rid]) + len(toks)
            while engine.short(0, upto) > 0:
                start, ids = engine.grow_blocks(0, engine.short(0, upto))
                for j, b in enumerate(ids):
                    cache = engine.grow_write(cache, 0, start + j, b)
            logits, cache = engine.decode(tokens, cache)
            toks.append(int(torch.argmax(logits[0])))
            tokens[0] = toks[-1]
        cache = engine.release(cache, 0)
        assert engine.leaked() == 0
        out[rid] = toks
    return out


def test_serve_matches_singleslot_engine(encdec_rig):
    _, _, tcfg, tparams, prompts, frames, gens, _, base = encdec_rig
    eng = EncDecEngine(tparams, tcfg, prompts, frames=frames, slots=1,
                       max_len=30, block_k=8)
    assert _single_slot_tokens(eng, len(prompts), gens) == base["finished"]


def test_overcommit_resumes_bitwise_as_reference(encdec_rig):
    """Pool pressure on the dynamic self-KV region (7 blocks; the carved
    bank sits on top): the same preemptions as the reference, every one
    resumed, the plain tokens, nothing leaked."""
    jcfg, jparams, tcfg, tparams, prompts, frames, gens, _, base = encdec_rig
    kw = dict(KW, gens=gens, frames=frames, pool_blocks=7)
    want = jserve.serve(jparams, jcfg, prompts, **kw)
    got = tserve.serve(tparams, tcfg, prompts, **kw)
    assert got["preemptions"] == want["preemptions"] > 0
    assert got["resumes"] == got["preemptions"]
    assert got["finished"] == base["finished"] == want["finished"]
    assert got["leaked_blocks"] == 0
    assert got["slot_prefills"] == want["slot_prefills"]


def test_forced_preempt_resumes_bitwise_as_reference(encdec_rig):
    jcfg, jparams, tcfg, tparams, prompts, frames, gens, _, base = encdec_rig
    kw = dict(KW, gens=gens, frames=frames)
    want = jserve.serve(jparams, jcfg, prompts,
                        fault_plan=JFaultPlan(preempt_step=2, preempt_slot=0),
                        **kw)
    got = tserve.serve(tparams, tcfg, prompts,
                       fault_plan=FaultPlan(preempt_step=2, preempt_slot=0),
                       **kw)
    assert got["preemptions"] == want["preemptions"] == 1
    assert got["finished"] == base["finished"] == want["finished"]
    assert got["leaked_blocks"] == 0


def test_composed_warm_and_repeated_runs_keep_the_tokens(encdec_rig):
    """``--fused off`` (the composed decode), ``warmup=True`` (two
    prefills and a decode step on a scratch pool first) and ``repeats=2``
    give the plain run's tokens."""
    _, _, tcfg, tparams, prompts, frames, gens, _, base = encdec_rig
    kw = dict(KW, gens=gens, frames=frames)
    comp = tserve.serve(tparams, tcfg.replace(attn_fused=False), prompts,
                        **kw)
    warm = tserve.serve(tparams, tcfg, prompts, warmup=True, repeats=2, **kw)
    assert comp["finished"] == warm["finished"] == base["finished"]
    assert (warm["warmup_prefills"], warm["warmup_decode_steps"]) == (2, 1)


def test_family_dispatch_rejections(encdec_rig):
    _, _, tcfg, tparams, prompts, frames, *_ = encdec_rig
    with pytest.raises(ValueError, match="encoder frames"):
        tserve.serve(tparams, tcfg, prompts, slots=2, gen=4)
    with pytest.raises(ValueError, match="no cache engine"):
        tserve.make_engine({}, tcfg.replace(family="hybrid"), prompts,
                           slots=2, max_len=32)
    with pytest.raises(ValueError, match="decoder-only"):
        tserve.serve(tparams, tcfg, prompts, slots=2, gen=4, frames=frames,
                     draft="self")
    with pytest.raises(ValueError, match="encdec"):
        tserve.serve(tparams, tcfg, prompts, slots=2, gen=4, frames=frames,
                     cache_kind="dense")
    for make in (tsteps.make_verify_step, tsteps.make_draft_loop):
        with pytest.raises(ValueError, match="decoder-only"):
            make(tcfg, *([4] if make is tsteps.make_draft_loop else []))
    with pytest.raises(ValueError, match="encoder length"):
        EncDecEngine(tparams, tcfg, prompts[:2],
                     frames=[frames[0], frames[1][:5]], slots=2, max_len=30)
    with pytest.raises(ValueError, match="pool_blocks"):
        EncDecEngine(tparams, tcfg, prompts, frames=frames, slots=2,
                     max_len=30, block_k=8, pool_blocks=3)


def test_carve_accounting(encdec_rig):
    """The cross bank is a fixed carve on top of the dynamic pool: its
    blocks never count as live, the leak check holds with the bank
    resident, and the pool is the reference's size with the same carved
    ids."""
    jcfg, jparams, tcfg, tparams, prompts, frames, gens, _, base = encdec_rig
    eng = EncDecEngine(tparams, tcfg, prompts, frames=frames, slots=3,
                       max_len=30, block_k=8)
    stats = run_schedule(eng, prompts, gens=gens)
    cross_bps = paged_kv.blocks_per_seq(frames[0].shape[0], 8)
    assert eng.alloc.carved_count == 3 * cross_bps
    assert eng.alloc.live_count == 0 and stats["leaked_blocks"] == 0
    assert stats["finished"] == base["finished"]
    ref = JEngine(jparams, jcfg, prompts, frames=frames, slots=3, max_len=30,
                  block_k=8)
    ref.start_run()
    assert eng.pool_size == ref.pool_size
    np.testing.assert_array_equal(eng.cross_table, ref.cross_table)
    assert (eng.kv_bytes_per_step(gens) == ref.kv_bytes_per_step(gens))
    with pytest.raises(paged_kv.BlockAllocationError, match="carved"):
        eng.alloc.free([int(eng.cross_table[0, 0])])


def test_cli_smoke_tokens_equal_reference_cli(capsys, monkeypatch):
    """Both CLIs on the same flags; the port's ``init_params`` hands out the
    reference CLI's parameters (``PRNGKey(seed)``), bridged, and both draw
    the encoder frames after the prompts from one generator."""
    argv = ["--arch", ARCH, "--smoke", "--requests", "4", "--slots", "2",
            "--prompt-len", "12", "--gen", "6", "--block-k", "8"]
    jserve.main(argv)
    want = capsys.readouterr().out

    def reference_params(cfg, *, seed, device, serving):
        assert serving and cfg.name == jget_arch(ARCH).smoke.name
        jcfg = jget_arch(ARCH).smoke.replace(dtype="float32")
        return bridge.from_jax_params(jax.device_get(
            jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(seed))), cfg,
            device=device)

    monkeypatch.setattr(TE, "init_params", reference_params)
    tserve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert "[paged:encdec:cpu] served 4 requests, 24 tokens" in got
    assert "0 leaked blocks" in got

    def req_lines(out):
        return [ln for ln in out.splitlines() if ln.startswith("  req ")]

    assert len(req_lines(want)) == 4
    assert req_lines(got) == req_lines(want)
