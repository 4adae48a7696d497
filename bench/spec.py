"""What a run reads by name: ``BENCHMARK.json`` at the checkout's root, a
cell's configuration file, its traffic mix and the per-layer metric
readers.  A later cell, configuration or metric is found here by adding
its files and its entry, without editing this module.

    BENCHMARK.json                  the cells, the metrics and their bounds
    bench/configs/<config>.json     a configuration as it is run
    bench/traffic/<traffic>.json    a traffic mix (parameters only)
    bench/metrics/<metric>.py       one per-layer metric's reader
    bench/refs/<reference>.py       a configuration's plain reference
    bench/systems/<system>.py       a configuration's program adapter:
                                    ``plan(conf)``, the leaves of the
                                    weights ``weights.py`` draws;
                                    ``make_engine(conf, W, prompts, *,
                                    slots, max_len)``, the port's engine
                                    over them; ``routed(conf)``, whether
                                    the check follows the program's
                                    expert routing
    bench/limits/<cell>.json        the limits of a cell's comparison
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: Dict, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    return json.loads((root / config_entry(bench, name)["file"]).read_text())


def load_traffic(name: str) -> Dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def load_limits(cell: str) -> Dict:
    """``bench/limits/<cell>.json``: the limit of each number compared."""
    return json.loads((BENCH_DIR / "limits" / f"{cell}.json").read_text())


def metrics_for(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _load_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``bench/metrics/<name>.py``'s ``read(ctx) -> Optional[float]``."""
    return _load_module(BENCH_DIR / "metrics" / f"{name}.py",
                        f"bench_metric_{name.replace('.', '_')}").read


def reference_module(name: str):
    """``bench/refs/<name>.py``: a configuration's plain reference."""
    return _load_module(BENCH_DIR / "refs" / f"{name}.py", f"bench_ref_{name}")


def system_module(name: str):
    """``bench/systems/<name>.py``: a configuration's program adapter."""
    return _load_module(BENCH_DIR / "systems" / f"{name}.py",
                        f"bench_system_{name}")


def check_names(bench: Dict) -> List[str]:
    """Every name, unit and key that the contract restricts, against its
    rule; the list of faults (empty when the file is sound)."""
    bad: List[str] = []

    def name(v, where):
        if not isinstance(v, str) or not NAME_RE.match(v):
            bad.append(f"{where}: name {v!r}")

    for c in bench["configs"]:
        name(c["name"], "config")
        for k in c["reduced"]:
            name(k, f"config {c['name']} reduced")
    for w in bench["workloads"]:
        name(w["name"], "workload")
        name(w["config"], f"workload {w['name']} config")
        name(w["traffic"], f"workload {w['name']} traffic")
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            name(m["name"], kind)
            if not UNIT_RE.match(m["unit"]):
                bad.append(f"{kind} {m['name']}: unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                bad.append(f"{kind} {m['name']}: better {m['better']!r}")
    return bad
