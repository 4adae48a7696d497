"""Dispatch: one public op per kernel (port of ``repro/kernels/ops.py``).

A CUDA tensor launches the hand-written kernel (or the wrapper raises); a
CPU tensor takes the kernel's plain PyTorch version.  There is no option
that sends a CUDA tensor to the plain version.

``m_z = s_q * s_k / (sqrt(f32(D)) * s_z)`` — the 32b->8b requant multiplier
— is computed here in f32, in the reference's order, so it is bit-equal.

Every split-softmax entry takes the reference's ``exact_recip`` (a
division in place of the reciprocal LUT, a compile-time variant of each
kernel).  Its ``lut_mode`` arrives as the ``exp_lut`` argument: the
``"compute"`` mode's values form a second 256-entry table
(``core.attention.luts_for``), which the same kernels read.

The dense decode and verify take the reference's ``block_k`` (None: ask
``autotune.decode_tile`` / ``verify_tile``, as the reference does) and
launch that tile's instance, a swept winner's; the heuristic's answer
(nothing swept for the shape) launches the default instance, the kernel
as it was before tiles were parameters.  The paged verify takes
``verify_tile``'s ``g_pad_min``, and the paged decode the pool's
``block_k``.  The
``exact_recip`` instances have no tile instances: with it the lookups are
not asked and the default instance runs.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.lut import LUTConfig
from repro_torch.kernels import autotune
from repro_torch.kernels import int8_matmul as int8_mm
from repro_torch.kernels import splitmax_attn
from repro_torch.kernels import splitmax_decode as decode_k


def requant_multiplier(s_q: torch.Tensor, s_k: torch.Tensor, d: int,
                       cfg: LUTConfig) -> torch.Tensor:
    """``s_q * s_k / (sqrt(d) * s_z)`` in f32.  The f32 denominator is formed
    on the host (no device tensor per call): the f64 square root rounded to
    f32 is the correctly rounded f32 square root, and the f32 product is
    exact in a Python float."""
    denom = float(np.float32(math.sqrt(d)) * np.float32(cfg.scale_z))
    return (s_q * s_k / denom).to(torch.float32)


def splitmax_attention(q_q, k_q, v_q, s_q, s_k, s_v, exp_lut, recip_lut, *,
                       cfg: LUTConfig, causal: bool = True,
                       window: Optional[int] = None,
                       kv_valid_len: Optional[int] = None,
                       exact_recip: bool = False) -> torch.Tensor:
    """(B,Hq,Sq,D) int8 x (B,Hkv,Sk,D) int8 -> (B,Hq,Sq,D) f32; per-tensor
    scales."""
    m_z = requant_multiplier(s_q, s_k, q_q.shape[-1], cfg).reshape(())
    fn = (splitmax_attn.splitmax_attention_cuda if q_q.is_cuda
          else splitmax_attn.splitmax_attention_plain)
    return fn(q_q.contiguous(), k_q.contiguous(), v_q.contiguous(), m_z,
              s_v.to(torch.float32).reshape(()),
              exp_lut, recip_lut, cfg=cfg, causal=causal, window=window,
              kv_valid_len=kv_valid_len, exact_recip=exact_recip)


def _per_slot_scale(s_q: torch.Tensor, b: int) -> torch.Tensor:
    """A scalar or one scale per slot (any shape with B or 1 elements) ->
    (B,) f32."""
    return s_q.to(torch.float32).reshape(-1).expand(b).contiguous()


def _per_token_scale(s_q: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """A verify scale -- scalar, (T,) or (B, T) -- -> (B, T) f32."""
    s = s_q.to(torch.float32)
    if s.dim() < 2:
        s = s.reshape(1, -1)
    return s.expand(b, t).contiguous()


def _decode_tile(d: int, s_max: int, block_k: Optional[int],
                 exact_recip: bool):
    """The dense decode's (block_k, g_pad_min), as the reference's
    ``ops.splitmax_decode`` picks it; ``block_k`` None (the default
    instance) for the heuristic's answer."""
    if block_k is not None:
        return block_k, 8
    if exact_recip:
        return None, 8
    bk, g_pad_min = autotune.decode_tile(d, s_max)
    return (bk if autotune.swept("decode", d, s_max) else None), g_pad_min


def splitmax_decode(q_q, k_cache, v_cache, s_q, s_k, s_v, cache_len, exp_lut,
                    recip_lut, *, cfg: LUTConfig,
                    window: Optional[int] = None,
                    block_k: Optional[int] = None,
                    exact_recip: bool = False) -> torch.Tensor:
    """Composed dense decode: int8 q_q (B,Hq,D) x int8 (B,Hkv,S_max,D)
    cache -> (B,Hq,D) f32.  ``s_q`` is the scale ``q_q`` was quantized
    with, a scalar or one per slot; it enters only through ``m_z``.
    ``block_k=None`` asks ``autotune.decode_tile`` for the tile."""
    b, _, d = q_q.shape
    s_q = _per_slot_scale(s_q, b)
    m_z = requant_multiplier(s_q, s_k.reshape(()), d, cfg)
    block_k, g_pad_min = _decode_tile(d, k_cache.shape[2], block_k,
                                      exact_recip)
    fn = (decode_k.splitmax_decode_cuda if q_q.is_cuda
          else decode_k.splitmax_decode_plain)
    return fn(q_q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
              m_z, s_v.to(torch.float32).reshape(()), cache_len, exp_lut,
              recip_lut, cfg=cfg, window=window, exact_recip=exact_recip,
              block_k=block_k, g_pad_min=g_pad_min)


def splitmax_decode_fused(q, k_cache, v_cache, s_q, s_k, s_v, cache_len,
                          exp_lut, recip_lut, *, cfg: LUTConfig,
                          window: Optional[int] = None,
                          block_k: Optional[int] = None,
                          exact_recip: bool = False) -> torch.Tensor:
    """Fused dense decode: f32-able q (B,Hq,D) + in-kernel quantize x int8
    (B,Hkv,S_max,D) cache -> (B,Hq,D) f32.  ``s_q`` is a scalar or one
    scale per slot.  ``block_k=None`` asks ``autotune.decode_tile``."""
    b, _, d = q.shape
    s_q = _per_slot_scale(s_q, b)
    m_z = requant_multiplier(s_q, s_k.reshape(()), d, cfg)
    block_k, g_pad_min = _decode_tile(d, k_cache.shape[2], block_k,
                                      exact_recip)
    fn = (decode_k.splitmax_decode_fused_cuda if q.is_cuda
          else decode_k.splitmax_decode_fused_plain)
    return fn(q.to(torch.float32).contiguous(), k_cache.contiguous(),
              v_cache.contiguous(), m_z, s_q,
              s_v.to(torch.float32).reshape(()), cache_len, exp_lut,
              recip_lut, cfg=cfg, window=window, exact_recip=exact_recip,
              block_k=block_k, g_pad_min=g_pad_min)


def splitmax_decode_fused_verify(q, k_cache, v_cache, s_q, s_k, s_v,
                                 cache_len, exp_lut, recip_lut, *,
                                 cfg: LUTConfig,
                                 window: Optional[int] = None,
                                 block_k: Optional[int] = None,
                                 exact_recip: bool = False) -> torch.Tensor:
    """Dense fused verify: f32-able draft queries q (B,Hq,T,D) vs the dense
    cache -> (B,Hq,T,D) f32.  ``s_q`` is a scalar, (T,) or (B,T);
    ``cache_len`` counts all T tokens, and token t attends ``cache_len -
    (T-1-t)`` positions.  ``block_k=None`` asks ``autotune.verify_tile``."""
    b, _, t, d = q.shape
    s_q = _per_token_scale(s_q, b, t)
    m_z = requant_multiplier(s_q, s_k.reshape(()), d, cfg)
    g_pad_min = 8
    if block_k is None and not exact_recip:
        s_max = k_cache.shape[2]
        block_k, g_pad_min = autotune.verify_tile(d, s_max, t)
        if not autotune.swept("verify", d, s_max, t):
            block_k = None
    fn = (decode_k.splitmax_decode_fused_verify_cuda if q.is_cuda
          else decode_k.splitmax_decode_fused_verify_plain)
    return fn(q.to(torch.float32).contiguous(), k_cache.contiguous(),
              v_cache.contiguous(), m_z, s_q,
              s_v.to(torch.float32).reshape(()), cache_len, exp_lut,
              recip_lut, cfg=cfg, window=window, exact_recip=exact_recip,
              block_k=block_k, g_pad_min=g_pad_min)


def splitmax_decode_paged(q_q, k_pages, v_pages, block_table, s_q, s_k, s_v,
                          cache_len, exp_lut, recip_lut, *, cfg: LUTConfig,
                          window: Optional[int] = None,
                          exact_recip: bool = False) -> torch.Tensor:
    """Composed paged decode: int8 q_q (B,Hq,D) + block-table gather ->
    (B,Hq,D) f32.  ``s_q`` is the scale ``q_q`` was quantized with, a
    scalar or one per slot; it enters only through ``m_z``."""
    b = q_q.shape[0]
    s_q = _per_slot_scale(s_q, b)
    m_z = requant_multiplier(s_q, s_k.reshape(()), q_q.shape[-1], cfg)
    fn = (decode_k.splitmax_decode_paged_cuda if q_q.is_cuda
          else decode_k.splitmax_decode_paged_plain)
    return fn(q_q.contiguous(), k_pages, v_pages, block_table, m_z,
              s_v.to(torch.float32).reshape(()), cache_len, exp_lut,
              recip_lut, cfg=cfg, window=window, exact_recip=exact_recip)


def splitmax_decode_fused_paged(q, k_pages, v_pages, block_table, s_q, s_k,
                                s_v, cache_len, exp_lut, recip_lut, *,
                                cfg: LUTConfig,
                                window: Optional[int] = None,
                                exact_recip: bool = False) -> torch.Tensor:
    """Fused paged decode: f32-able q (B,Hq,D) + in-kernel quantize +
    block-table gather -> (B,Hq,D) f32.  ``s_q`` is a scalar or one scale
    per slot (any shape with B or 1 elements)."""
    b = q.shape[0]
    s_q = _per_slot_scale(s_q, b)
    m_z = requant_multiplier(s_q, s_k.reshape(()), q.shape[-1], cfg)
    fn = (decode_k.splitmax_decode_fused_paged_cuda if q.is_cuda
          else decode_k.splitmax_decode_fused_paged_plain)
    return fn(q.to(torch.float32).contiguous(), k_pages, v_pages,
              block_table, m_z, s_q, s_v.to(torch.float32).reshape(()),
              cache_len, exp_lut, recip_lut, cfg=cfg, window=window,
              exact_recip=exact_recip)


def splitmax_decode_fused_verify_paged(q, k_pages, v_pages, block_table, s_q,
                                       s_k, s_v, cache_len, exp_lut,
                                       recip_lut, *, cfg: LUTConfig,
                                       window: Optional[int] = None,
                                       exact_recip: bool = False
                                       ) -> torch.Tensor:
    """Paged fused verify: f32-able draft queries q (B,Hq,T,D) vs the pool
    -> (B,Hq,T,D) f32.  ``s_q`` is a scalar, (T,) or (B,T); ``cache_len``
    counts all T tokens, and token t attends ``cache_len - (T-1-t)``
    positions.  The query rows' padding is ``autotune.verify_tile``'s
    ``g_pad_min``, as the reference's."""
    b, _, t, d = q.shape
    s_q = _per_token_scale(s_q, b, t)
    m_z = requant_multiplier(s_q, s_k.reshape(()), d, cfg)
    g_pad_min = 8
    if not exact_recip:
        _, g_pad_min = autotune.verify_tile(
            d, k_pages.shape[2] * block_table.shape[1], t)
    fn = (decode_k.splitmax_decode_fused_verify_paged_cuda if q.is_cuda
          else decode_k.splitmax_decode_fused_verify_paged_plain)
    return fn(q.to(torch.float32).contiguous(), k_pages, v_pages,
              block_table, m_z, s_q, s_v.to(torch.float32).reshape(()),
              cache_len, exp_lut, recip_lut, cfg=cfg, window=window,
              exact_recip=exact_recip, g_pad_min=g_pad_min)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                multiplier: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M,K) int8 @ (K,N) int8 -> int32, or int8 through the fused requant
    ``clip(round(f32(acc) * multiplier))`` when a scalar multiplier is
    given."""
    if multiplier is not None:
        multiplier = torch.as_tensor(multiplier, dtype=torch.float32,
                                     device=x_q.device).reshape(())
    fn = int8_mm.int8_matmul_cuda if x_q.is_cuda else int8_mm.int8_matmul_plain
    return fn(x_q.contiguous(), w_q.contiguous(), multiplier)


def int8_matmul_shared_w(xs, w_q: torch.Tensor) -> list:
    """Several (M_i,K) int8 operands times one (K,N) int8 ``w_q`` -> their
    int32 products; on the card ``w_q`` is packed K-major once and each
    product is one launch of the GEMM body."""
    if w_q.is_cuda:
        return int8_mm.int8_matmul_shared_w_cuda(
            [x.contiguous() for x in xs], w_q.contiguous())
    return [int8_mm.int8_matmul_plain(x, w_q) for x in xs]
