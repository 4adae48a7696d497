"""What a run may load and read: no JAX and no JAX package (top-level
names compared whole, since ``repro_torch`` begins with ``repro``), nothing
of ``benchmarks/``; no result without a card or without the program."""
import os
import re
import shutil
import subprocess
import sys
import types

import torch

from bench_tiny import BENCH

ROOT = BENCH.parent
RUN_TINY = f"""
import sys
sys.path[:0] = [{str(BENCH / 'tests')!r}]
import bench_tiny
bench_tiny.run("deepseek-moe-16b.code")
sys.path.insert(0, {str(BENCH)!r})
import run
print(run.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", RUN_TINY], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run
    for name in ("repro_torch_x", "jaxlike", "reprox"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [n for n in run.forbidden_modules()
                if n in ("repro_torch_x", "jaxlike", "reprox")]
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert "repro.core" in run.forbidden_modules()


def test_nothing_under_bench_reads_benchmarks():
    me = os.path.basename(__file__)
    for p in BENCH.rglob("*"):
        if p.suffix in (".py", ".json") and p.name != me:
            text = p.read_text()
            assert not re.search(r"\bbenchmarks\b", text), p


def _no_result(cwd):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "deepseek-67b-int8.chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=cwd, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout == ""


def test_no_card_no_result():
    if torch.cuda.is_available():
        return          # on a card this would run the cell
    _no_result(ROOT)


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(tmp_path)
