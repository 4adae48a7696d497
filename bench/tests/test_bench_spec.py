"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
import json
import re

import pytest

from bench_tiny import BENCH
import spec

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == TOP_KEYS
    assert bench["paths"] == ["bench"]
    assert bench["command"] == ["python3", "bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units_are_legal(bench):
    assert spec.check_names(bench) == []
    for bad in ("a b", "x/y", "", "é", "-" * 65):
        assert not spec.NAME_RE.match(bad)
    assert spec.UNIT_RE.match("tokens/s") and not spec.UNIT_RE.match("tok per s")


def test_entries_have_only_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


@pytest.mark.parametrize("kind", ["config", "system", "traffic", "limits"])
def test_every_cell_finds_its_files(bench, kind):
    for w in bench["workloads"]:
        if kind == "config":
            conf = spec.load_config(bench, w["config"])
            assert conf["name"] == w["config"]
            spec.reference_module(conf["reference"])
        elif kind == "system":
            conf = spec.load_config(bench, w["config"])
            system = spec.system_module(conf["system"])
            for fn in ("plan", "make_engine", "routed"):
                assert callable(getattr(system, fn))
            plan = system.plan(conf)
            assert plan and all(kind in ("int8", "compute", "f32")
                                for _, _, _, kind in plan)
            lim = spec.load_limits(w["name"])
            assert ("max_layer_route_gap" in lim) == system.routed(conf)
        elif kind == "traffic":
            assert spec.load_traffic(w["traffic"])["clients"] >= 1
        else:
            lim = spec.load_limits(w["name"])
            assert lim and set(lim) <= {"max_logit_gap", "mean_logit_gap",
                                        "max_layer_route_gap"}
            assert all(v > 0 for v in lim.values())


def test_every_metric_finds_its_reader(bench):
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics_for(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(bench, w["name"], "per_layer")
        for m in spec.metrics_for(bench, w["name"], "per_layer"):
            assert m["moves"] in e2e


def test_config_files_state_no_reduction(bench):
    for c in bench["configs"]:
        conf = spec.load_config(bench, c["name"])
        assert conf["reduced"] == c["reduced"] == []
        assert conf["source"] == c["source"]
        assert (BENCH.parent / c["file"]).is_file()
        assert c["file"].startswith("bench/")


def test_files_under_paths_are_named_by_names():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(BENCH.parent).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
