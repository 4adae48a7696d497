"""Roofline terms of one step at the NVIDIA H100 SXM's datasheet constants
(port of ``repro/launch/roofline.py``, whose constants are a TPU's).

Constants, per GPU, from NVIDIA's H100 Tensor Core GPU data sheet (the SXM
form factor, dense, i.e. without the 2:4 sparsity factor):

    bf16 tensor core     989 TFLOP/s
    int8 tensor core   1,979 TOP/s
    HBM3                3.35 TB/s
    NVLink 4             900 GB/s in total, both directions summed

``LINK_BW`` takes one direction, 450 GB/s: a GPU sends and receives at once,
and the collective bytes below count what a GPU receives.

The three terms (seconds, per step, per GPU):

    compute    = flops / PEAK_FLOPS_BF16
    memory     = hbm_bytes / HBM_BW
    collective = collective_bytes / LINK_BW

The counts come from the dry-run (``launch/dryrun.py``), which runs the
step eagerly on DTensors and counts rank 0's local aten ops, and they are
not the reference's quantities: the reference reads XLA's
``cost_analysis`` of the compiled per-device program.

* flops: ``torch.utils.flop_counter``'s formulas, which cover matrix
  products, convolutions and attention only; XLA counts elementwise flops
  too.  Every flop is timed at the bf16 peak, as in the reference.
* hbm_bytes: each aten op's input and output bytes, summed op by op — an
  unfused count, an upper bound on what a fused program moves (XLA counts
  per fusion).
* collective bytes: the result sizes of the c10d functional collectives,
  the reference's convention (ring factors ~2(n-1)/n are absorbed into it).

So the two packages' raw terms are never one quantity; a term is compared
only within one package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS_BF16 = 989e12          # FLOP/s per GPU, dense bf16
PEAK_OPS_INT8 = 1979e12           # OP/s per GPU, dense int8
HBM_BW = 3.35e12                  # B/s per GPU, HBM3
NVLINK_BW_TOTAL = 900e9           # B/s per GPU, both directions summed
LINK_BW = NVLINK_BW_TOTAL / 2     # B/s per GPU, one direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class RooflineTerms:
    flops: float                  # per-GPU flops
    hbm_bytes: float              # per-GPU bytes accessed (unfused)
    coll_bytes: float             # per-GPU collective bytes (result sizes)
    coll_breakdown: Dict[str, int]
    model_flops: float            # 6*N*D (global, all GPUs)
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops summed over GPUs)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time(self) -> float:
        """Roofline step-time estimate: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline estimate."""
        denom = self.step_time * self.chips * PEAK_FLOPS_BF16
        return self.model_flops / denom if denom else 0.0

    def summary(self) -> Dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_step_s": self.step_time,
            "roofline_mfu": self.mfu,
        }


def model_flops_for(cfg, kind: str, seq: int, batch: int) -> float:
    """6*N*D (train) / 2*N*D (forward-only) with N = active params."""
    n = cfg.active_param_count() if cfg.family == "moe" else cfg.param_count()
    if kind == "train":
        tokens = seq * batch
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = seq * batch
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * batch


def measured_mfu(model_flops: float, step_s: float, chips: int = 1) -> float:
    """Model-flops utilization of a measured step time."""
    denom = step_s * chips * PEAK_FLOPS_BF16
    return model_flops / denom if denom else 0.0
