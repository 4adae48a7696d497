"""Fault injection, health records and the straggler watchdog of the port
against the JAX reference (mirrors ``tests/test_faults.py``).

Each fault of ``repro_torch.launch.faults`` is driven through the port's
serving loops and held against the reference's run under the same plan,
from the same bridged parameters:

  * pool exhaustion -> preemption and stalls, then bitwise recovery, plain
    and speculative;
  * NaN logits -> the finite guard retires exactly the poisoned request,
    plain and speculative;
  * a scheduler delay -> flagged by the watchdog;
  * the metrics document has the reference's keys, and everything in it
    but the straggler reports and the timings equals the reference's.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.dist import straggler as jstrag
from repro.launch import faults as jfaults
from repro.launch import health as jhealth
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import paged_kv
from repro_torch.dist import straggler as tstrag
from repro_torch.launch import faults as tfaults
from repro_torch.launch import health as thealth
from repro_torch.launch import serve as tserve

torch.set_num_threads(1)

KW = dict(slots=3, gen=10, cache_kind="paged", block_k=8, max_len=40)
TIMING = ("tok_s", "wall_s", "p50_step_ms", "p99_step_ms")


@pytest.fixture(scope="module")
def rig():
    """test_faults.py's rig: 6 requests of 16 tokens over 3 slots."""
    jcfg = jget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    tcfg = tget_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    jparams = jsteps.init_params_fn(jcfg)(jax.random.PRNGKey(2))
    tparams = bridge.from_jax_params(jax.device_get(jparams), tcfg,
                                     device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, 16, dtype=np.int32)
               for _ in range(6)]
    gens = [10, 8, 10, 6, 10, 8]
    base = tserve.serve(tparams, tcfg, prompts, gens=gens, **KW)
    assert base["finished"] == jserve.serve(jparams, jcfg, prompts,
                                            gens=gens, **KW)["finished"]
    return jcfg, jparams, tcfg, tparams, prompts, gens, base


def _both(rig, plan: dict, **kw):
    """The reference's and the port's run under the same fault plan."""
    jcfg, jparams, tcfg, tparams, prompts, gens, _ = rig
    kw = dict(KW, gens=gens, **kw)
    jdraft = kw.pop("jdraft", None)
    tdraft = kw.pop("tdraft", None)
    want = jserve.serve(jparams, jcfg, prompts, draft=jdraft,
                        fault_plan=jfaults.FaultPlan(**plan), **kw)
    got = tserve.serve(tparams, tcfg, prompts, draft=tdraft,
                       fault_plan=tfaults.FaultPlan(**plan), **kw)
    return want, got


def _same_outcome(want, got):
    steps = "verify_steps" if "verify_steps" in want else "decode_steps"
    for key in ("finished", "failed", "expired", "preemptions", "resumes",
                "slot_prefills", "leaked_blocks", steps):
        assert got[key] == want[key], key
    for key in ("counters", "pools", "faults", "events"):
        assert got["health"][key] == want["health"][key], key


# ------------------------------ plan and parts -------------------------------

def test_fault_plan_from_env_parses_all_knobs():
    env = {"REPRO_FAULT_EXHAUST": "12:6", "REPRO_FAULT_DELAY": "3:0.5",
           "REPRO_FAULT_NAN": "7:2", "REPRO_FAULT_PREEMPT": "4:1",
           "REPRO_FAULT_SEED": "42"}
    short = {"REPRO_FAULT_EXHAUST": "5", "REPRO_FAULT_NAN": "9",
             "REPRO_FAULT_PREEMPT": "2"}
    for e in (env, short, {}):
        got = tfaults.FaultPlan.from_env(e)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jfaults.FaultPlan.from_env(e))
        assert got.armed == bool(e)
    plan = tfaults.FaultPlan.from_env(env)
    assert (plan.exhaust_step, plan.exhaust_hold) == (12, 6)
    assert (plan.delay_step, plan.delay_seconds) == (3, 0.5)
    assert (plan.nan_step, plan.nan_slot) == (7, 2)
    assert (plan.preempt_step, plan.preempt_slot) == (4, 1)
    assert plan.seed == 42
    plan = tfaults.FaultPlan.from_env(short)
    assert (plan.exhaust_step, plan.exhaust_hold) == (5, 4)
    assert (plan.nan_step, plan.nan_slot) == (9, 0)
    assert (plan.preempt_step, plan.preempt_slot) == (2, 0)


def test_injector_steal_and_drain_never_leak():
    """Stolen blocks come back after the hold, and drain() returns them
    when the run ends inside the hold."""
    health = thealth.ServeHealth()
    inj = tfaults.FaultInjector(tfaults.FaultPlan(exhaust_step=2,
                                                  exhaust_hold=3), health)
    alloc = paged_kv.BlockAllocator(8)
    inj.squeeze_pool(2, alloc)
    assert alloc.free_count == 0
    with pytest.raises(paged_kv.BlockAllocationError):
        alloc.alloc(1)
    inj.squeeze_pool(4, alloc)               # still inside the hold
    assert alloc.free_count == 0
    inj.squeeze_pool(5, alloc)               # the hold is over
    assert alloc.free_count == 7
    inj.squeeze_pool(6, alloc)               # past the armed step: inert
    assert alloc.free_count == 7
    inj2 = tfaults.FaultInjector(tfaults.FaultPlan(exhaust_step=0,
                                                   exhaust_hold=99), health)
    inj2.squeeze_pool(0, alloc)
    assert alloc.free_count == 0
    inj2.drain(alloc)
    assert alloc.free_count == 7 and alloc.live_count == 0
    kinds = [f["kind"] for f in health.faults]
    assert kinds == ["exhaust", "exhaust_release", "exhaust"]
    assert health.counters["faults_injected"] == 3


@pytest.mark.parametrize("shape", [(3, 11), (3, 2, 11)],
                         ids=["decode", "verify"])
def test_corrupt_logits_returns_a_new_tensor(shape):
    """The NaN fault poisons one slot's row in a new tensor and leaves the
    step's own logits alone; other steps pass the tensor through."""
    logits = torch.randn(shape)
    keep = logits.clone()
    inj = tfaults.FaultInjector(tfaults.FaultPlan(nan_step=4, nan_slot=1))
    assert inj.corrupt_logits(3, logits) is logits
    out = inj.corrupt_logits(4, logits)
    assert torch.equal(logits, keep)
    assert torch.isnan(out[1]).all()
    assert torch.equal(out[0], keep[0]) and torch.equal(out[2], keep[2])


def test_health_record_equals_reference(tmp_path):
    """The same calls on both records give the same document."""
    records = []
    for mod in (jhealth, thealth):
        h = mod.ServeHealth()
        h.count("preemptions")
        h.count("resumed_tokens_replayed", 5)
        h.count("spec_parks")
        h.event("preempt", 3, rid=2, slot=1)
        h.fault({"kind": "nan", "step": 4, "slot": 0})
        h.straggler(tstrag.StragglerReport(step=7, seconds=0.3, median=0.01,
                                           ratio=30.0, window=6))
        alloc = paged_kv.BlockAllocator(9)
        alloc.alloc(5)
        h.pool("kv", alloc)
        records.append(h.to_dict())
        path = h.write_json(tmp_path / mod.__name__ / "health.json")
        assert json.loads(path.read_text()) == h.to_dict()
    assert records[0] == records[1]
    assert records[1]["pools"]["kv"] == {
        "num_blocks": 9, "high_water": 5, "live_at_end": 5,
        "peak_live_fraction": 5 / 8}


def test_straggler_watchdog_equals_reference():
    """The same step times flag the same steps with the same reports, and
    expected-slow steps stay out of the window."""
    rng = np.random.default_rng(0)
    times = list(rng.uniform(0.009, 0.011, 40))
    times[12], times[25], times[26] = 0.05, 0.2, 0.2
    slow = {5, 25}
    dogs = [m.StragglerWatchdog(window=10, threshold=3.0, min_history=4)
            for m in (jstrag, tstrag)]
    for step, t in enumerate(times):
        flags = [d.observe(step, t, expect_slow=step in slow) for d in dogs]
        assert (flags[0] is None) == (flags[1] is None)
    want, got = ([r.to_dict() for r in d.reports] for d in dogs)
    assert got == want and [r["step"] for r in got] == [12, 26]
    assert dogs[1].summary() == dogs[0].summary()
    with pytest.raises(ValueError):
        tstrag.StragglerWatchdog(threshold=1.0)


# ------------------------------ end-to-end chaos -----------------------------

def test_chaos_exhaustion_recovers_like_reference(rig):
    """Steal every free block mid-run: both packages preempt and stall
    through the hold the same way and finish with the unfaulted tokens."""
    want, got = _both(rig, dict(exhaust_step=3, exhaust_hold=6))
    _same_outcome(want, got)
    assert got["finished"] == rig[-1]["finished"]
    assert got["preemptions"] > 0 and got["leaked_blocks"] == 0
    assert [f["kind"] for f in got["health"]["faults"]] == [
        "exhaust", "exhaust_release"]


def test_chaos_exhaustion_speculative_like_reference(rig):
    want, got = _both(rig, dict(exhaust_step=2, exhaust_hold=8),
                      jdraft="self", tdraft="self", gamma=3, pool_blocks=8)
    _same_outcome(want, got)
    assert got["finished"] == rig[-1]["finished"]
    assert got["preemptions"] > 0 and got["leaked_blocks"] == 0


def test_chaos_nan_retires_only_the_poisoned_request(rig):
    want, got = _both(rig, dict(nan_step=5, nan_slot=1))
    _same_outcome(want, got)
    assert len(got["failed"]) == 1
    assert got["served"] == 5 and got["leaked_blocks"] == 0
    for rid, toks in got["finished"].items():
        assert toks == rig[-1]["finished"][rid]
    assert got["health"]["counters"]["nan_retired"] == 1


@pytest.mark.parametrize("drafter", ["self", "prefix"])
def test_chaos_nan_speculative_verify(rig, drafter):
    """The finite guard covers the verify logits; a distinct drafter's pool
    drains with the target's."""
    jcfg, jparams, tcfg, tparams = rig[:4]
    draft = {} if drafter == "self" else dict(
        jdraft=jserve.make_self_draft(jparams, jcfg, 1),
        tdraft=tserve.make_self_draft(tparams, tcfg, 1))
    kw = {"jdraft": "self", "tdraft": "self", "gamma": 3, **draft}
    want, got = _both(rig, dict(nan_step=2, nan_slot=0), **kw)
    _same_outcome(want, got)
    assert len(got["failed"]) == 1 and got["leaked_blocks"] == 0
    if drafter == "prefix":
        assert got["health"]["pools"]["draft_kv"]["live_at_end"] == 0


def test_chaos_forced_preemption_like_reference(rig):
    want, got = _both(rig, dict(preempt_step=4, preempt_slot=1))
    _same_outcome(want, got)
    assert got["preemptions"] == got["resumes"] == 1
    assert got["finished"] == rig[-1]["finished"]


def test_chaos_delay_trips_watchdog(rig):
    """A stall injected before one step is flagged against the steady
    decode steps and recorded."""
    _, _, tcfg, tparams, prompts, gens, base = rig
    stats = tserve.serve(tparams, tcfg, prompts, gens=gens, **KW,
                         fault_plan=tfaults.FaultPlan(delay_step=10,
                                                      delay_seconds=0.25))
    assert stats["finished"] == base["finished"]
    assert 10 in [r["step"] for r in stats["health"]["stragglers"]]
    assert stats["health"]["straggler_summary"]["flagged"] >= 1


def test_chaos_metrics_json_equals_reference(rig, tmp_path):
    """The metrics document of a chaos run: the reference's keys, and its
    counters, pools, faults, events and run summary equal, all but the
    straggler reports and the timings."""
    jcfg, jparams, tcfg, tparams, prompts, gens, _ = rig
    plan = dict(exhaust_step=3, exhaust_hold=5, delay_step=12,
                delay_seconds=0.2, seed=7)
    kw = dict(KW, gens=gens, pool_blocks=10, deadline_steps=200)
    docs = []
    for serve, faults, params, cfg in ((jserve, jfaults, jparams, jcfg),
                                       (tserve, tfaults, tparams, tcfg)):
        out = tmp_path / f"{serve.__name__}.json"
        serve.serve(params, cfg, prompts, fault_plan=faults.FaultPlan(**plan),
                    metrics_json=str(out), **kw)
        docs.append(json.loads(out.read_text()))
    want, got = docs
    assert set(got) == set(want)
    assert set(got["run"]) == set(want["run"])
    for key in ("counters", "pools", "faults", "events"):
        assert got[key] == want[key], key
    for key in set(got["run"]) - set(TIMING):
        assert got["run"][key] == want["run"][key], key
    assert set(got["straggler_summary"]) == set(want["straggler_summary"])
    assert got["counters"]["faults_injected"] >= 2
    assert got["pools"]["kv"]["live_at_end"] == 0
    assert got["run"]["served"] == len(prompts)
    assert any(r["step"] == 12 for r in got["stragglers"])


def test_cli_chaos_drill_on_cpu(tmp_path, monkeypatch, capsys):
    """The port's counterpart of ``make chaos``: the REPRO_FAULT_* knobs
    and every serving flag through the CLI on the CPU."""
    monkeypatch.setenv("REPRO_FAULT_EXHAUST", "6:5")
    monkeypatch.setenv("REPRO_FAULT_NAN", "4:1")
    out = tmp_path / "health.json"
    tserve.main(["--smoke", "--device", "cpu", "--requests", "6", "--slots",
                 "3", "--prompt-len", "16", "--gen", "12", "--block-k", "8",
                 "--pool-blocks", "9", "--preempt-policy", "longest",
                 "--deadline-steps", "200", "--deadline-ms", "1e9",
                 "--metrics-json", str(out)])
    printed = capsys.readouterr().out
    assert "health:" in printed and "1 NaN-retired" in printed
    assert "0 leaked blocks" in printed
    doc = json.loads(out.read_text())
    assert doc["counters"]["faults_injected"] == 3
    assert doc["counters"]["nan_retired"] == 1
    assert doc["run"]["served"] + len(doc["run"]["failed"]) == 6
