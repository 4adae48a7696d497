"""Symmetric int8 quantization — the numeric substrate of CIMple (port of
``repro/core/quantization.py``: calibration, quantize/dequantize and
:class:`QuantizedTensor`, the float and the pure-integer Q15 32b->8b
requant, the straight-through fake quant of QAT training, and the int8
serve weights of :func:`quantize_weights_for_serving`).

Bit-exactness with the reference rests on three choices that must not
drift: the scale is ``max(absmax, 1e-8) / 127`` in f32, quantize *divides*
by the scale (IEEE division, no reciprocal multiply), and rounding is
half-to-even before the int8 clip.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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


@dataclasses.dataclass
class QuantizedTensor:
    """int8 payload + float32 scale (the reference's pytree node; here a
    plain pair)."""

    q: torch.Tensor          # int8
    scale: torch.Tensor      # float32, scalar or broadcastable

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def dequantize(self) -> torch.Tensor:
        return dequantize(self.q, self.scale)

    @classmethod
    def from_float(cls, x: torch.Tensor, axis=None) -> "QuantizedTensor":
        s = absmax_scale(x, axis=axis)
        return cls(q=quantize(x, s), scale=s)


def requantize_int32(acc: torch.Tensor, real_multiplier: torch.Tensor
                     ) -> torch.Tensor:
    """int32 accumulator -> int8, as the 32b->8b quantization unit:
    ``clip(round(acc * m))`` in f32 (exact for |acc| < 2^24)."""
    y = torch.round(acc.to(torch.float32) * real_multiplier)
    return torch.clamp(y, INT8_MIN, INT8_MAX).to(torch.int8)


def requant_params_q15(real_multiplier) -> Tuple[torch.Tensor, torch.Tensor]:
    """A real multiplier in (0, 1) as ``m_q15 * 2^-shift``: ``m_q15`` a
    15-bit unsigned mantissa in [2^14, 2^15] (rounded half to even; a
    mantissa that rounds up to 2^15 is halved and the exponent raised) and
    ``shift`` the total arithmetic right shift, both int32."""
    m = torch.as_tensor(real_multiplier, dtype=torch.float32)
    frac, e = torch.frexp(m)                 # m = frac * 2^e, frac in [0.5, 1)
    q15 = torch.round(frac * (1 << 15))
    overflow = q15 >= (1 << 15)
    q15 = torch.where(overflow, q15 / 2, q15)
    e = torch.where(overflow, e + 1, e)
    return q15.to(torch.int32), (15 - e).to(torch.int32)


def rounding_rshift(x: torch.Tensor, shift) -> torch.Tensor:
    """Arithmetic right shift of int32 ``x`` with round-half-up: the bias
    ``2^(shift-1)`` is added in int32 (wrapping as the reference's does)
    before the shift."""
    x = x.to(torch.int32)
    shift = torch.as_tensor(shift, dtype=torch.int32, device=x.device)
    one = torch.ones((), dtype=torch.int32, device=x.device)
    bias = torch.where(shift > 0, one << torch.clamp_min(shift - 1, 0),
                       torch.zeros_like(one))
    return (x + bias) >> shift


def requantize_int32_bitexact(acc: torch.Tensor, real_multiplier,
                              zero_point: int = 0) -> torch.Tensor:
    """The pure-integer Q15 requant pipeline, int32 only: pre-shift the
    accumulator so it fits 16 bits (rounding, then saturating like the
    hardware), multiply by the Q15 mantissa, round-shift down, add the zero
    point, saturate to int8.  Within 1 LSB of :func:`requantize_int32`."""
    acc = acc.to(torch.int32)
    m_q15, shift = requant_params_q15(real_multiplier)
    m_q15, shift = m_q15.to(acc.device), shift.to(acc.device)
    pre = torch.clamp_min(shift - 15, 0)
    post = shift - pre
    acc_s = torch.clamp(rounding_rshift(acc, pre), -(1 << 15), (1 << 15) - 1)
    y = rounding_rshift(acc_s * m_q15, post)
    return torch.clamp(y + zero_point, INT8_MIN, INT8_MAX).to(torch.int8)


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


def quantize_weight(w: torch.Tensor, *, consume: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A weight leaf as an int8 serve weight ``(q, s)``: the absmax scale
    over its last two (matmul) dims, kept ``(..., 1, 1)``, and
    ``quantize(w, s)``, the same bits as :func:`absmax_scale` and
    :func:`quantize`.  The absmax is ``max(amax, -amin)`` (no ``|w|``
    temporary) and the quotient one f32 temporary; ``consume=True`` (an
    f32 ``w`` its caller drops) divides in ``w``'s own storage instead, so
    that a serving init holds no f32 copy beyond its draw (a 102400 x 8192
    head is 3.4 GB in f32)."""
    dims = (w.dim() - 2, w.dim() - 1)
    amax = torch.maximum(w.amax(dim=dims, keepdim=True),
                         -w.amin(dim=dims, keepdim=True))
    s = torch.clamp_min(amax.to(torch.float32), 1e-8) / float(INT8_MAX)
    q = w.div_(s) if consume and w.dtype == torch.float32 else (
        w.to(torch.float32) / s)
    q.round_().clamp_(INT8_MIN, INT8_MAX)
    return q.to(torch.int8), s


def quantize_weights_for_serving(params, *, consume: bool = False):
    """Every linear weight ``{"w": t}`` and embedding ``{"table": t}`` with
    ``t.dim() >= 2`` becomes an int8 payload and its f32 scale
    (``w_q``/``w_s``, ``table_q``/``table_s``; :func:`quantize_weight`,
    which ``consume`` is passed to: a serving init's own f32 draws);
    norms, biases, the MoE expert stacks and the other leaves stay as they
    are (the same tensors).  The port keeps a layer per list entry where
    the reference stacks them, and reduces over the last two dims as the
    reference does, so each per-layer scale is the reference's stacked
    scale at that layer.  Layers dequantize at use
    (``models/layers.linear_apply``)."""
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_weights_for_serving(v, consume=consume)
                            for v in params)
    if not isinstance(params, dict):
        return params
    out = {}
    for key, val in params.items():
        if isinstance(val, (dict, list, tuple)):
            out[key] = quantize_weights_for_serving(val, consume=consume)
        elif key in ("w", "table") and val.dim() >= 2:
            out[key + "_q"], out[key + "_s"] = quantize_weight(
                val, consume=consume)
        else:
            out[key] = val
    return out
