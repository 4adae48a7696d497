"""The controls of ``correct``, and the readings its limits are set from:
for each seed, one run of the cell (its own traffic, sizes and window),
the program's numbers (those a run compares) and each control's: the
plain reference put in the program's place at a precision below the
configuration's, each position's gap read for the token that the lower
precision puts first.  With routed experts the lower precision also
routes by itself, and the f32 reference follows its routing, as it
follows the program's (``cell.reference_gaps``).

* int8 serve weights -> int4 weights (symmetric, one absmax scale a
  matrix, each expert's own in a stack);
* bf16 -> fp8 (e4m3) weights (one scale a matrix) and fp8 inputs to every
  matrix product (one scale a row): an fp8 serving path; and int8
  weights (symmetric, one absmax scale a matrix, each expert's own).

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --control 3

One JSON line a seed; the controls are read on the first ``--control``
seeds, the program on all.  Each reading goes through the cell's limits
by the run's own judge (:func:`cell.judge`), and the line gives the
``correct`` it comes to: true for the program, false for each control.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import torch  # noqa: E402

import cell  # noqa: E402
import spec  # noqa: E402

FP8_MAX = 448.0


def _matrix_dims(w: torch.Tensor):
    return (w.dim() - 2, w.dim() - 1) if w.dim() >= 2 else (w.dim() - 1,)


class IntWeights:
    """Symmetric integer weights of ``qmax`` levels a side, one absmax
    scale a matrix; the matrix products' inputs as they are."""

    def __init__(self, bits: int):
        self.name = f"int{bits} weights"
        self.qmax = 2 ** (bits - 1) - 1

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        s = torch.clamp_min(w.abs().amax(dim=_matrix_dims(w), keepdim=True),
                            1e-8) / self.qmax
        return torch.clamp(torch.round(w / s), -self.qmax, self.qmax) * s

    @staticmethod
    def act(x: torch.Tensor) -> torch.Tensor:
        return x


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    s = torch.clamp_min(x.abs().amax(dim=dims, keepdim=True), 1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Fp8:
    name = "fp8 e4m3 weights and matmul inputs"

    @staticmethod
    def weight(w: torch.Tensor) -> torch.Tensor:
        return _fp8(w, _matrix_dims(w))

    @staticmethod
    def act(x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, (-1,))


def controls_for(conf):
    if conf["serve"]["serve_param_dtype"] == "int8":
        return [IntWeights(4)]
    return [Fp8, IntWeights(8)]


def readings(W, conf, prompts, served, routes=None):
    """Each control's numbers (``routes``, the program's, go unused: a
    control routes by itself)."""
    return [{"control": low.name,
             **cell.reference_gaps(W, conf, prompts, served, low=low)}
            for low in controls_for(conf)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=40)
    ap.add_argument("--control", type=int, default=3,
                    help="read the control on the first N seeds only")
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    c = spec.workload(bench, args.workload)
    lim = spec.load_limits(c["name"])
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = cell.run_cell(bench, c, seed, args.seconds, False, t_start=t0,
                            extra=readings if i < args.control else None)
        ctl = out["counters"].get("extra")
        print(json.dumps({"seed": seed, "program": out["check"],
                          "program_correct": cell.judge(out["check"], lim)[0],
                          "control": ctl,
                          "control_correct": ([cell.judge(x, lim)[0]
                                               for x in ctl] if ctl else None),
                          "tok_s": out["e2e"]["tok_s"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
