"""Over-committed serving in the port against the JAX reference (mirrors
``tests/test_overcommit.py``): demand paging, preemption and resume,
deadlines.

With the block pool sized below ``slots * blocks_per_seq``, requests are
preempted (blocks freed, request re-queued) and resumed (prompt
re-prefilled, recorded prefix replayed through the decode batch).  Both
packages serve the same prompts from the same bridged parameters; the port
must make the same scheduling decisions (preemptions, resumes, prefills,
expiries, health counters) and emit the same greedy tokens, which equal the
full-pool run's, with no block leaked.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import paged_kv
from repro_torch.launch import faults as tfaults
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.engines import PagedKVEngine, SSMStateEngine

torch.set_num_threads(1)

KW = dict(slots=4, gen=12, cache_kind="paged", block_k=8, max_len=40)


@pytest.fixture(scope="module")
def rig():
    """test_overcommit.py's rig: 8 requests of 16 tokens over 4 slots,
    block_k 8, max_len 40 (a full pool would be 21 blocks)."""
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = tget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(2))
    tparams = bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                     device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, 16, dtype=np.int32)
               for _ in range(8)]
    gens = [12, 10, 12, 8, 12, 10, 8, 12]
    want = jserve.serve(jparams, jcfg, prompts, gens=gens, **KW)
    base = tserve.serve(tparams, tcfg, prompts, gens=gens, **KW)
    assert base["finished"] == want["finished"]
    assert base["preemptions"] == want["preemptions"] == 0
    return jcfg, jparams, tcfg, tparams, prompts, gens, base


def _same_decisions(got, want):
    for key in ("preemptions", "resumes", "slot_prefills", "decode_steps",
                "leaked_blocks", "batch_prefills"):
        assert got[key] == want[key], key
    assert got["health"]["counters"] == want["health"]["counters"]
    assert got["health"]["pools"] == want["health"]["pools"]


@pytest.mark.parametrize("policy", ["newest", "longest"])
@pytest.mark.parametrize("pool", [13, 7])
def test_overcommit_equals_reference(rig, policy, pool):
    """A pool for ~2 (or ~1) sequences: both packages preempt and resume
    the same requests; every request finishes with the full-pool tokens."""
    jcfg, jparams, tcfg, tparams, prompts, gens, base = rig
    want = jserve.serve(jparams, jcfg, prompts, gens=gens, pool_blocks=pool,
                        preempt_policy=policy, **KW)
    got = tserve.serve(tparams, tcfg, prompts, gens=gens, pool_blocks=pool,
                       preempt_policy=policy, **KW)
    assert got["preemptions"] > 0
    assert got["resumes"] == got["preemptions"]
    assert got["finished"] == want["finished"] == base["finished"]
    assert got["slot_prefills"] == len(prompts) + got["resumes"]
    assert got["leaked_blocks"] == 0
    _same_decisions(got, want)


def test_minimum_pool_serializes_admissions(rig):
    """One max-length sequence plus the trash block: admissions stall and
    serialize the requests, a lone resident never needs preempting."""
    _, _, tcfg, tparams, prompts, gens, base = rig
    bps = paged_kv.blocks_per_seq(40, 8)
    stats = tserve.serve(tparams, tcfg, prompts[:4], gens=gens[:4],
                         **dict(KW, slots=2), pool_blocks=1 + bps)
    assert stats["finished"] == {r: base["finished"][r] for r in range(4)}
    assert stats["leaked_blocks"] == 0
    assert stats["health"]["counters"]["admission_stalls"] > 0


def test_make_engine_serves_the_dense_family_only(rig):
    """The paged engine serves the dense and (since the MoE slice) the MoE
    family; since the SSM slice the SSM family gets the state-slab engine,
    which has no pool to over-commit and refuses ``pool_blocks`` as the
    reference's does."""
    _, _, tcfg, tparams, prompts, _, _ = rig
    assert isinstance(tserve.make_engine(tparams, tcfg, prompts, slots=2,
                                         max_len=40), PagedKVEngine)
    ssm = tget_arch("falcon_mamba_7b").smoke.replace(dtype="float32")
    sparams = tsteps.init_params_fn(ssm)(seed=0, device="cpu")
    assert isinstance(tserve.make_engine(sparams, ssm, prompts, slots=2,
                                         max_len=40), SSMStateEngine)
    with pytest.raises(ValueError, match="paged KV cache"):
        tserve.make_engine(sparams, ssm, prompts, slots=2, max_len=40,
                           pool_blocks=8)


def test_pool_floor_is_enforced(rig):
    _, _, tcfg, tparams, prompts, gens, _ = rig
    bps = paged_kv.blocks_per_seq(40, 8)
    with pytest.raises(ValueError, match="cannot hold one sequence"):
        tserve.serve(tparams, tcfg, prompts, gens=gens, pool_blocks=bps,
                     **dict(KW, slots=2))


@pytest.mark.parametrize("policy", ["newest", "longest"])
def test_preempt_then_retire_no_double_free(rig, policy):
    """A tiny pool and staggered retirements: a double free of a
    preempted-then-retired slot's blocks would raise inside the run."""
    _, _, tcfg, tparams, prompts, gens, base = rig
    stats = tserve.serve(tparams, tcfg, prompts, gens=gens, pool_blocks=9,
                         preempt_policy=policy, **dict(KW, slots=3))
    assert stats["finished"] == base["finished"]
    assert stats["leaked_blocks"] == 0


def test_growth_at_exact_block_boundary(rig):
    """Prompts of exactly 2 blocks: the first decode write lands on a fresh
    block, which must be covered before that write."""
    _, _, tcfg, tparams, _, _, _ = rig
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, 16, dtype=np.int32)
               for _ in range(4)]
    kw = dict(slots=2, gen=8, cache_kind="paged", block_k=8, max_len=32)
    full = tserve.serve(tparams, tcfg, prompts, **kw)
    tight = tserve.serve(tparams, tcfg, prompts, pool_blocks=6, **kw)
    assert tight["finished"] == full["finished"]
    assert tight["leaked_blocks"] == 0


def test_deadline_steps_equals_reference(rig):
    """A tight step deadline expires the requests that waited; both
    packages expire the same ones with the same tokens."""
    jcfg, jparams, tcfg, tparams, prompts, gens, base = rig
    kw = dict(KW, slots=3)
    want = jserve.serve(jparams, jcfg, prompts, gens=gens, deadline_steps=8,
                        **kw)
    got = tserve.serve(tparams, tcfg, prompts, gens=gens, deadline_steps=8,
                       **kw)
    assert got["expired"] and got["expired"] == want["expired"]
    assert got["finished"] == want["finished"]
    assert got["health"]["counters"] == want["health"]["counters"]
    assert got["health"]["counters"]["deadline_cancelled"] == \
        len(got["expired"])
    for rid, toks in got["finished"].items():
        assert toks == base["finished"][rid]
    assert set(got["finished"]) | set(got["expired"]) == set(range(8))
    assert got["leaked_blocks"] == 0


def test_huge_deadline_ms_equals_no_deadline(rig):
    """A wall-clock deadline nobody reaches changes nothing, earliest
    deadline first included, under pressure too."""
    _, _, tcfg, tparams, prompts, gens, base = rig
    plain = tserve.serve(tparams, tcfg, prompts, gens=gens, pool_blocks=7,
                         **KW)
    edf = tserve.serve(tparams, tcfg, prompts, gens=gens, pool_blocks=7,
                       deadline_ms=1e9, **KW)
    assert edf["finished"] == plain["finished"] == base["finished"]
    assert not edf["expired"]
    assert edf["health"]["counters"] == plain["health"]["counters"]


@pytest.mark.parametrize("name", ["self", "prefix"])
def test_overcommit_speculative_equals_reference(rig, name):
    """The speculative scheduler under the same pressure: parks, then
    preemptions, the same in both packages, and plain greedy tokens."""
    jcfg, jparams, tcfg, tparams, _, _, _ = rig
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, 16, dtype=np.int32)
               for _ in range(3)]
    kw = dict(slots=2, gen=12, gens=[12, 12, 12], cache_kind="paged",
              block_k=8, max_len=39, gamma=3, pool_blocks=7)
    plain = tserve.serve(tparams, tcfg, prompts, **dict(kw, pool_blocks=None))
    jdraft = "self" if name == "self" else jserve.make_self_draft(
        jparams, jcfg, 1)
    tdraft = "self" if name == "self" else tserve.make_self_draft(
        tparams, tcfg, 1)
    want = jserve.serve(jparams, jcfg, prompts, draft=jdraft, **kw)
    got = tserve.serve(tparams, tcfg, prompts, draft=tdraft, **kw)
    assert got["finished"] == want["finished"] == plain["finished"]
    assert got["leaked_blocks"] == 0
    assert got["preemptions"] == want["preemptions"] > 0
    assert got["health"]["counters"] == want["health"]["counters"]
    assert got["health"]["pools"] == want["health"]["pools"]


@pytest.mark.parametrize("name", ["self", "prefix"])
def test_speculative_warmup_and_repeats_keep_the_tokens(rig, name):
    """The speculative warm-up round runs on scratch pools (two with a
    distinct drafter) and repeats rerun the schedule: neither changes a
    token or leaks a block."""
    _, _, tcfg, tparams, prompts, gens, base = rig
    draft = None if name == "self" else tserve.make_self_draft(
        tparams, tcfg, 1)
    kw = dict(slots=4, gen=12, gens=gens, block_k=8, max_len=40, gamma=3,
              draft=draft)
    stats = tserve.serve_speculative(tparams, tcfg, prompts, warmup=True,
                                     repeats=2, **kw)
    assert stats["finished"] == base["finished"]
    assert stats["leaked_blocks"] == 0


def test_calibrating_request_resumes_with_identical_scales(rig):
    """The first admitted request calibrates the pool's scales, and its
    re-admission after a preemption calibrates again: from the same prompt
    through the same step, the scales must come out bit for bit equal, or
    every co-resident's K/V would be read with other scales."""
    _, _, tcfg, tparams, prompts, gens, base = rig
    engine = tserve.make_engine(tparams, tcfg, prompts, slots=2, max_len=40,
                                block_k=8)
    cache = engine.start_run()
    engine.admit(cache, 0, 0)
    scales = (cache["scale_k"].clone(), cache["scale_v"].clone())
    engine.admit(cache, 1, 1)
    cache = engine.release(cache, 0)
    engine.admit(cache, 0, 0)
    assert torch.equal(cache["scale_k"], scales[0])
    assert torch.equal(cache["scale_v"], scales[1])
    cache = engine.release(cache, 0)
    engine.release(cache, 1)
    assert engine.leaked() == 0
    # end to end: force-preempt slot 0 (request 0, the calibrating one)
    stats = tserve.serve(tparams, tcfg, prompts, gens=gens,
                         fault_plan=tfaults.FaultPlan(preempt_step=3), **KW)
    assert stats["preemptions"] == stats["resumes"] == 1
    assert stats["health"]["events"][0]["rid"] == 0
    assert stats["finished"] == base["finished"]


def test_sampled_overcommit_completes_leak_free(rig):
    """Sampling under over-commit: every request at full length, nothing
    leaked, and (count-addressed keys) the full pool's tokens."""
    _, _, tcfg, tparams, prompts, gens, _ = rig
    kw = dict(KW, gens=gens, temperature=0.7, top_p=0.9)
    full = tserve.serve(tparams, tcfg, prompts, **kw)
    tight = tserve.serve(tparams, tcfg, prompts, pool_blocks=13, **kw)
    assert tight["preemptions"] > 0
    assert all(len(tight["finished"][r]) == gens[r] for r in range(8))
    assert tight["finished"] == full["finished"]
    assert tight["leaked_blocks"] == 0
