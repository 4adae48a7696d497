"""The port's span recorder (``repro_torch/trace.py``): off it keeps nothing
and reads no clock, on the serving path too; on, spans nest with the right
parents, carry a request's id from its admission to its last decode, take
the stamps a caller hands them, and a drain clears them."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch import trace
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

torch.set_num_threads(1)


@pytest.fixture
def rec():
    trace.disable()
    trace.drain()
    yield trace
    trace.disable()
    trace.drain()


def _serve(requests=5, slots=2, seed=0):
    """A churn of int8-weight TinyLlama smoke requests through the paged
    engine and ``run_schedule``."""
    cfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32",
                                                   serve_param_dtype="int8")
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(9, 20, requests)]
    gens = [int(g) for g in rng.integers(2, 6, requests)]
    out = serve.serve_paged(params, cfg, prompts, slots=slots, gen=6,
                            gens=gens, block_k=8)
    return cfg, prompts, gens, out


def test_off_records_nothing_and_reads_no_clock(rec, monkeypatch):
    def no_clock():
        raise AssertionError("the recorder read a clock while off")

    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter_ns=no_clock, time_ns=no_clock))
    assert trace.span("engine.admit", rid=1) is trace.OFF
    with trace.span("sched.iteration", start=1.0, step=0) as s:
        s.end(2.0)
    trace.record("build", 1.0, 2.0, source="x")
    trace.routing(torch.zeros(2, dtype=torch.long), torch.zeros(2))
    w = {"w_q": torch.ones((4, 3), dtype=torch.int8),
         "w_s": torch.full((1, 1), 0.5)}
    assert torch.equal(L.linear_weight(w), torch.full((4, 3), 0.5))
    _serve()                        # every instrumented serving call
    monkeypatch.undo()
    assert trace.drain() == {"spans": [], "routes": []}


def test_spans_nest_under_their_parents(rec):
    trace.enable()
    with trace.span("a", k=1):
        with trace.span("b"):
            trace.record("c", 10.0, 10.5, source="s")
        it = trace.span("d", start=11.0, step=7)
        it.end(12.0)
    with trace.span("e"):
        pass
    out = trace.drain()
    by = {s["name"]: s for s in out["spans"]}
    assert [s["name"] for s in out["spans"]] == ["c", "b", "d", "a", "e"]
    assert by["a"]["parent"] is None and by["e"]["parent"] is None
    assert by["b"]["parent"] == by["d"]["parent"] == by["a"]["id"]
    assert by["c"]["parent"] == by["b"]["id"]
    assert len({s["id"] for s in out["spans"]}) == 5
    assert by["a"]["attrs"] == {"k": 1} and by["c"]["attrs"] == {"source": "s"}
    assert by["d"]["attrs"] == {"step": 7} and by["b"]["attrs"] == {}
    # the caller's stamps, moved onto the profiler's clock by one offset
    assert by["c"]["t1"] - by["c"]["t0"] == 500_000_000
    assert by["d"]["t1"] - by["d"]["t0"] == 1_000_000_000
    assert by["d"]["t0"] - by["c"]["t0"] == 1_000_000_000
    assert by["a"]["t0"] <= by["b"]["t0"] <= by["b"]["t1"] <= by["a"]["t1"]


def test_drain_clears_and_disable_drops_open_spans(rec):
    trace.enable()
    with trace.span("x"):
        pass
    open_one = trace.span("y")
    assert [s["name"] for s in trace.drain()["spans"]] == ["x"]
    assert trace.drain() == {"spans": [], "routes": []}
    trace.disable()
    open_one.end()
    trace.enable()
    with trace.span("z"):
        pass
    spans = trace.drain()["spans"]
    assert [s["name"] for s in spans] == ["z"] and spans[0]["parent"] is None


def test_profiler_offset_is_the_epoch_less_perf_counter():
    import time
    off = trace.profiler_offset_ns()
    now = time.perf_counter_ns() + off
    assert abs(now - time.time_ns()) < 5_000_000


def test_serving_spans_carry_the_request_id(rec):
    trace.enable()
    cfg, prompts, gens, out = _serve()
    spans = trace.drain()["spans"]
    ids = {s["id"]: s for s in spans}
    parent = {s["id"]: ids.get(s["parent"], {}).get("name") for s in spans}
    admits = [s for s in spans if s["name"] == "engine.admit"]
    firsts = [s for s in spans if s["name"] == "sched.first_token"]
    assert sorted(s["attrs"]["rid"] for s in admits) == \
        list(range(len(prompts)))
    assert [s["attrs"]["rid"] for s in firsts] == \
        [s["attrs"]["rid"] for s in admits]
    for s in admits:
        assert s["attrs"]["prompt_len"] == len(prompts[s["attrs"]["rid"]])
        assert parent[s["id"]] == "sched.iteration"
    # a request's decodes: from its admission to its last token
    decodes = [s for s in spans if s["name"] == "engine.decode"]
    steps = {r: sum(r in s["attrs"]["rids"] for s in decodes)
             for r in range(len(prompts))}
    assert steps == {r: gens[r] - 1 for r in range(len(prompts))}
    assert {r: len(t) for r, t in out["finished"].items()} == dict(
        enumerate(gens))
    assert all(len(s["attrs"]["rids"]) <= 2 for s in decodes)
    # the model's spans, inside the engine's calls; the head's dequant
    # directly inside the step
    kinds = [(s["attrs"]["kind"], parent[s["id"]]) for s in spans
             if s["name"] == "model.step"]
    assert kinds.count(("prefill", "engine.admit")) == len(prompts)
    assert kinds.count(("decode", "engine.decode")) == len(decodes)
    layers = [s for s in spans if s["name"] == "model.layer"]
    assert len(layers) == cfg.n_layers * len(kinds)
    assert {s["attrs"]["i"] for s in layers} == set(range(cfg.n_layers))
    deq = [parent[s["id"]] for s in spans if s["name"] == "dequant"]
    assert set(deq) == {"model.layer", "model.step"}
    assert deq.count("model.step") == len(kinds)
    assert sum(s["name"] == "sched.sample_read" for s in spans) == \
        len(decodes)
    its = [s for s in spans if s["name"] == "sched.iteration"]
    assert [s["attrs"]["step"] for s in its] == list(range(len(its)))
    for s in spans:                 # every child inside its parent
        p = ids.get(s["parent"])
        if p is not None:
            assert p["t0"] <= s["t0"] <= s["t1"] <= p["t1"], s["name"]
