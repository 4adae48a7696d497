"""Symmetric int8 quantization — the numeric substrate of CIMple (port of
``repro/core/quantization.py``: calibration, quantize/dequantize, the float
32b->8b requant and the straight-through fake quant of QAT training).

Bit-exactness with the reference rests on three choices that must not
drift: the scale is ``max(absmax, 1e-8) / 127`` in f32, quantize *divides*
by the scale (IEEE division, no reciprocal multiply), and rounding is
half-to-even before the int8 clip.
"""
from __future__ import annotations

import torch

INT8_MIN = -128
INT8_MAX = 127


def absmax_scale(x: torch.Tensor, axis=None, eps: float = 1e-8
                 ) -> torch.Tensor:
    """Symmetric scale s such that round(x/s) covers [-127, 127].

    ``axis=None`` -> per-tensor scalar; otherwise the reduction axes are
    collapsed with keepdims (per-row / per-slot quantization).
    """
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    amax = torch.clamp_min(amax.to(torch.float32), eps)
    return amax / float(INT8_MAX)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float -> int8 with round-to-nearest-even and saturation."""
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def requantize_int32(acc: torch.Tensor, real_multiplier: torch.Tensor
                     ) -> torch.Tensor:
    """int32 accumulator -> int8, as the 32b->8b quantization unit:
    ``clip(round(acc * m))`` in f32 (exact for |acc| < 2^24)."""
    y = torch.round(acc.to(torch.float32) * real_multiplier)
    return torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int8)


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize to the int8 grid with the straight-through
    gradient of the reference's ``jax.custom_vjp``: ``g`` passes where
    ``-128 * scale <= x <= 127 * scale`` (both ends included), zero
    elsewhere, and ``scale`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        q = torch.clamp(torch.round(x / scale), INT8_MIN, INT8_MAX)
        return q * scale

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        inside = (x >= INT8_MIN * scale) & (x <= INT8_MAX * scale)
        return torch.where(inside, g, torch.zeros((), dtype=g.dtype,
                                                  device=g.device)), None


def fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -128, 127) * scale`` (a true division,
    half-to-even rounding) with the STE gradient; ``scale`` is an f32
    tensor broadcastable to ``x``."""
    return _FakeQuant.apply(x, scale)


def fake_quant_calibrated(x: torch.Tensor, axis=None) -> torch.Tensor:
    """absmax-calibrated STE fake quant (the scale is a constant)."""
    return fake_quant(x, absmax_scale(x.detach(), axis=axis))
