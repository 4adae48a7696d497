"""CIMple's LUT-based split softmax, reference semantics (port of
``repro/core/split_softmax.py``).

Scores are int8-quantized, so ``z_quant_max = 127`` bounds every score and
``e^(z_q - 127) <= 1``: the row-max pass goes away, the numerator ``E[z_q]
. V`` and the denominator ``sum E[z_q]`` accumulate in one pass, and one
reciprocal-LUT multiply replaces the division.

  * :func:`safe_softmax`             — float 3-pass baseline
  * :func:`lut_split_softmax_probs`  — the LUT path as float probabilities
  * :func:`split_softmax_attention`  — the int8 attention epilogue
  * :func:`fakequant_split_softmax`  — the differentiable (STE) variant of
                                       QAT training, the oracle of
                                       :func:`repro_torch.kernels.blocked.blocked_fakequant_attention`
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core import quantization as qlib
from repro_torch.core.lut import LUTConfig, Z_QUANT_MAX


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def safe_softmax(z: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 axis: int = -1) -> torch.Tensor:
    """Three-pass safe softmax (max -> exp-sum -> divide), float32."""
    z = z.to(torch.float32)
    if mask is not None:
        z = torch.where(mask, z, -math.inf)
    zmax = torch.amax(z, dim=axis, keepdim=True)
    # fully-masked rows: zmax = -inf -> all zeros
    zmax = torch.where(torch.isfinite(zmax), zmax, 0.0)
    e = torch.exp(z - zmax)
    s = torch.sum(e, dim=axis, keepdim=True)
    return e / torch.clamp_min(s, 1e-30)


def lut_split_softmax_probs(z: torch.Tensor, cfg: LUTConfig,
                            exp_lut: torch.Tensor, recip_lut: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            axis: int = -1,
                            exact_recip: bool = False) -> torch.Tensor:
    """softmax(z) as the hardware computes it: float scores quantized with
    ``cfg.scale_z``, exponentials from the exp LUT, the division from the
    reciprocal LUT (an exact division with ``exact_recip``)."""
    z_q = qlib.quantize(z, _f32(cfg.scale_z, z.device))
    e = lut_lib.exp_lookup(z_q, exp_lut)              # int32 in [0, 2^f_e]
    if mask is not None:
        e = torch.where(mask, e, 0)
    s = torch.sum(e.to(torch.float32), dim=axis, keepdim=True)
    if exact_recip:
        return e.to(torch.float32) / torch.clamp_min(s, 1.0)
    r, exp2 = lut_lib.recip_lookup(torch.clamp_min(s, 1.0).to(torch.int32),
                                   recip_lut, cfg)
    return lut_lib.recip_apply(e, r, exp2)


def split_softmax_attention(z: torch.Tensor, v_q: torch.Tensor,
                            v_scale: torch.Tensor, cfg: LUTConfig,
                            exp_lut: torch.Tensor, recip_lut: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            out_scale: Optional[torch.Tensor] = None,
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """softmax(z) @ V through the split datapath: ``z (..., n_q, n_k)``
    float scores, ``v_q (..., n_k, d_v)`` int8.  Returns the dequantized
    output and, with ``out_scale``, its int8 requantization."""
    z_q = qlib.quantize(z, _f32(cfg.scale_z, z.device))
    e = lut_lib.exp_lookup(z_q, exp_lut)
    if mask is not None:
        e = torch.where(mask, e, 0)
    e_f = e.to(torch.float32)
    acc_v = e_f @ v_q.to(torch.float32)                        # numerator . V
    acc_s = torch.sum(e_f, dim=-1, keepdim=True)               # denominator
    r, exp2 = lut_lib.recip_lookup(
        torch.clamp_min(acc_s, 1.0).to(torch.int32), recip_lut, cfg)
    out = lut_lib.recip_apply(acc_v, r, exp2) * v_scale
    out_q = None if out_scale is None else qlib.quantize(out, out_scale)
    return out, out_q


def lut_floor(cfg: LUTConfig) -> float:
    """The exp LUT's representability floor ``-(f_e + 1) ln 2``, in f32: an
    entry rounds to 0 where ``exp(zdot) * 2^f_e < 0.5``."""
    return float(np.float32(-(cfg.exp_frac_bits + 1) * np.float32(np.log(2.0))))


def fakequant_split_softmax(z: torch.Tensor, cfg: LUTConfig,
                            mask: Optional[torch.Tensor] = None,
                            axis: int = -1) -> torch.Tensor:
    """Training-time split softmax: the int8 LUT path's forward numerics
    (scores snapped to the int8 grid, the ``z_quant_max`` shift, the LUT's
    dead zone below :func:`lut_floor`) with the STE gradient and an exact
    division."""
    s_z = _f32(cfg.scale_z, z.device)
    z_fq = qlib.fake_quant(z.to(torch.float32), s_z)
    zdot = z_fq - Z_QUANT_MAX * s_z                     # <= 0
    e = torch.exp(zdot)
    e = torch.where(zdot < lut_floor(cfg), 0.0, e)
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    s = torch.sum(e, dim=axis, keepdim=True)
    return e / torch.clamp_min(s, 1e-30)


def make_luts(cfg: LUTConfig, device="cpu"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(exp LUT, recip LUT) as int32 tensors on ``device``."""
    return (torch.from_numpy(lut_lib.build_exp_lut(cfg)).to(device),
            torch.from_numpy(lut_lib.build_recip_lut(cfg)).to(device))
