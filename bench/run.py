"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the device trace of a bounded span of the window).
Standard output's last line is one JSON object; the numbers compared to
decide ``correct`` are also the last lines of standard error.  Exits with
another code than 0, and prints no result, without a CUDA device (or
fewer than the cell asks for), or when ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` is loaded once the window has closed.

The program's only cache is inside the checkout: its kernels build once
into ``src/repro_torch/kernels/_build`` (the first run of a checkout).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def card(fields: str) -> str:
    """``nvidia-smi``'s reading of ``fields``: the card's name and power
    limit before the run; its clock, power draw, temperature and throttle
    reasons when the window closes, printed beside the numbers."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import spec
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: the cell {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import cell as cell_run
    before = card("name,power.limit")
    out = cell_run.run_cell(
        bench, cell, args.seed, args.seconds, bool(args.trace),
        t_start=T_START, probe=lambda: card(
            "clocks.sm,power.draw,temperature.gpu,"
            "clocks_throttle_reasons.active"))
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules of the JAX package or of JAX are loaded: {bad}",
              file=sys.stderr)
        return 3
    line = cell_run.result_line(bench, cell, out, bool(args.trace),
                                torch.cuda.get_device_name(0))
    print(json.dumps({"card": before, "counters": out["counters"],
                      "e2e": out["e2e"], "setup_s": out["setup_s"],
                      "check": out["check"]}), flush=True)
    for k, v in line["check"].items():
        print(f"check: {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
