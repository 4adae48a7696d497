"""The MoE cell's check follows the program's routing: the port's recorded
top-k ids, handed to the plain reference in place of its own top-k, and
the routing held against the reference's own router by itself (the route
gaps), at the small size of ``deepseek-moe-16b.code``."""
import torch

import bench_tiny
import cell
import spec
from repro_torch.models import moe

NAME = "deepseek-moe-16b.code"


def _both_ways(got):
    """``extra``: the reference on its own top-k and on the program's ids."""
    def extra(W, conf, prompts, served, routes):
        ref = spec.reference_module(conf["reference"])
        keys, seqs, plens, calib, at = cell.sequences(prompts, served)
        follow = [{layer: ids[:len(s)] for layer, ids in routes[r].items()}
                  for r, s in zip(keys, seqs)]
        got["own"] = ref.logits_at(W, conf, seqs, plens, calib, at)
        got["led"] = ref.logits_at(W, conf, seqs, plens, calib, at,
                                   routes=follow)
        got["program"] = follow
        return {}
    return extra


def _differ(a, b):
    return sum(int((x[layer] != y[layer]).any(-1).sum())
               for x, y in zip(a, b) for layer in x)


def test_float32_the_program_routes_as_the_reference():
    """(a) float32 on both sides: the recorded ids are the reference's own
    top-k at every position and MoE layer, the route gap reads 0, and the
    logits with and without the program's ids are the same bits."""
    got = {}
    bench, c, out = bench_tiny.run(NAME, extra=_both_ways(got))
    own, led = got["own"], got["led"]
    assert sorted(got["program"][0]) == [1, 2]        # layer 0 is dense
    assert _differ(own["routes"], got["program"]) == 0
    assert led["route_gap_layers"] == [0.0, 0.0]
    assert out["check"]["max_layer_route_gap"] == 0
    assert all(torch.equal(a, b) for a, b in zip(own["logits"], led["logits"]))
    assert out["counters"]["route_bytes"] > 0
    assert cell.result_line(bench, c, out, False, "cpu")["correct"] is True


def test_bf16_routing_differs_and_is_followed():
    """(b) bf16 compute in the program: some positions route otherwise than
    the reference's own router would, and with the reference following
    the program's ids the run is judged correct."""
    got = {}
    _, _, out = bench_tiny.run(NAME, dtype="bfloat16", extra=_both_ways(got))
    assert _differ(got["own"]["routes"], got["program"]) > 0
    assert out["check"]["max_layer_route_gap"] > 0
    assert cell.judge(out["check"], out["limits"])[0] is True


def test_a_planted_routing_fault_is_not_correct(monkeypatch):
    """(c) the program's router, in its last MoE layer, takes its least
    expert for its k-th: the reference follows that routing, so the served
    tokens may still agree, but that layer's mean route gap fails the
    cell's own limit.  (At this width the router's logits have a std of
    ~0.16 against ~0.9 at the cell's, so the (k+1)-th expert in its place
    reads ~0.05 here; that fault is read at the cell's size on the chip,
    ``PERF.md`` section 2.)"""
    real = moe.route
    calls = {"n": 0}

    def swapped(params, x, cfg):
        logits, probs, vals, idx = real(params, x, cfg)
        calls["n"] += 1
        if calls["n"] % 2 == 0:       # layers 1 and 2 are MoE: layer 2
            k = cfg.moe.top_k
            order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
            idx = torch.cat([idx[..., :k - 1], order[..., -1:]], dim=-1)
        return logits, probs, vals, idx

    monkeypatch.setattr(moe, "route", swapped)
    bench, c, out = bench_tiny.run(NAME)
    lim = out["limits"]
    assert out["check"]["max_layer_route_gap"] > lim["max_layer_route_gap"]
    assert cell.result_line(bench, c, out, False, "cpu")["correct"] is False
