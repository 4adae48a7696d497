"""The plain reference against the port's CPU path (the plain versions of
its kernels) at small sizes of both cells, float32: every served token is
the reference's best.  Then the check with the timed path broken
underneath, and the control, each of which must come out not correct."""
import pytest
import torch

import bench_tiny
import cell
import control
import spec
from bench_tiny import CELLS


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    bench, c, out = bench_tiny.run(name)
    chk = out["check"]
    assert chk["tokens"] >= 10
    # float32 on both sides: only an int8 rounding edge that the two
    # GEMMs' summation orders put on different sides flips a near tie
    assert chk["max_logit_gap"] < 0.1
    line = cell.result_line(bench, c, out, False, "cpu")
    assert line["correct"] is True
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert set(line["metrics"]) == {
        m["name"] for m in spec.metrics_for(bench, name, "end_to_end")}
    assert out["counters"]["early_releases"] == 0


class _Wrap:
    def __init__(self, engine):
        self.e = engine

    def __getattr__(self, name):
        return getattr(self.e, name)


class AlteredToken(_Wrap):
    """A decode's token altered where it is produced."""

    def decode(self, tokens, cache):
        lg, cache = self.e.decode(tokens, cache)
        lg = lg.clone()
        lg[:, 7] += 100.0
        return lg, cache


class AlteredFirstToken(_Wrap):
    """An admission's token altered where it is produced."""

    def admit(self, cache, slot, rid):
        lg, cache = self.e.admit(cache, slot, rid)
        lg = lg.clone()
        lg[:, 11] += 100.0
        return lg, cache


class StateUnchanged(_Wrap):
    """A decode step that returns its state (the int8 KV pool, the
    lengths) unchanged."""

    def decode(self, tokens, cache):
        saved = {k: v.clone() for k, v in cache.items()}
        lg, cache = self.e.decode(tokens, cache)
        for k, v in saved.items():
            cache[k].copy_(v)
        return lg, cache


class HalfTheBatch(_Wrap):
    """A decode that computes the first half of its slots and gives the
    rest the first half's rows."""

    def decode(self, tokens, cache):
        lg, cache = self.e.decode(tokens, cache)
        h = lg.shape[0] // 2
        lg = lg.clone()
        lg[h:2 * h] = lg[:h]
        return lg, cache


@pytest.mark.parametrize("fault", [AlteredToken, AlteredFirstToken,
                                   StateUnchanged, HalfTheBatch])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_is_not_correct(name, fault):
    bench, c, out = bench_tiny.run(name, wrap=fault)
    lim = out["limits"]
    assert any(out["check"][k] > lim[k] for k in lim)
    assert cell.result_line(bench, c, out, False, "cpu")["correct"] is False


def _controls(got):
    def extra(W, conf, prompts, served, routes):
        got.extend(control.readings(W, conf, prompts, served, routes))
        return got
    return extra


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_far_above_the_program(name):
    """At this size the cell's limits, set at the cell's own size, do not
    carry over; each control still reads at least three times the program
    (which reads 0 here, float32 on both sides) on a compared number: the
    chat cell's one, the MoE cell's logit gap (int8 weights move its
    routing less at this width than at the cell's)."""
    got = []
    _, _, out = bench_tiny.run(name, extra=_controls(got))
    assert [c["control"] for c in got] == [
        low.name for low in control.controls_for(out["ctx"]["conf"])]
    for ctl in got:
        assert ctl["max_logit_gap"] > max(3 * out["check"]["max_logit_gap"],
                                          0.05)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_judged_not_correct(name):
    """Each control's readings, through the routes path where the cell has
    routed experts, by the run's own judge under the cell's own limits:
    the program is correct, and the configuration's first control (int4
    weights for the chat cell, fp8 for the MoE cell) is not.  The MoE
    cell's int8-weights control reads under those limits at this width
    and depth; it is held to three times the program by the test above
    and judged not correct at the cell's own size on the chip."""
    got = []
    _, _, out = bench_tiny.run(name, seed=2 ** 31 + 19, extra=_controls(got))
    lim = out["limits"]
    assert cell.judge(out["check"], lim)[0] is True
    assert len(got) == len(control.controls_for(out["ctx"]["conf"]))
    for ctl in got:
        assert ("max_layer_route_gap" in ctl) == ("max_layer_route_gap" in lim)
    correct, read = cell.judge(got[0], lim)
    assert correct is False
    assert all(read[k] == got[0][k] for k in lim)


def test_control_precisions():
    w = torch.linspace(-1, 1, 64).reshape(2, 4, 8)
    q4 = control.IntWeights(4).weight(w)
    assert len(torch.unique(q4[0])) <= 15
    q8 = control.IntWeights(8).weight(w)
    assert len(torch.unique(q8[0])) <= 255
    assert torch.allclose(q8, w, atol=1 / 127)
    assert torch.allclose(control.Fp8.weight(w), w, rtol=0.07)
    assert not torch.equal(control.Fp8.act(w), w)
