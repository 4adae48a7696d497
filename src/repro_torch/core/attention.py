"""CIMple attention datapath (port of ``repro/core/attention.py``: the
three modes of ``attention``, ``decode_attention`` and
``paged_decode_attention`` -- int8 fused and composed, and the float
baselines -- and ``paged_verify_attention``).

  * ``"float"``     — 3-pass safe-softmax attention (the paper's baseline);
  * ``"fakequant"`` — training (QAT): scores snap to the int8 grid through a
                      straight-through estimator and the softmax takes the
                      static ``z_quant_max`` ceiling, the differentiable twin
                      of the deployed datapath (plain PyTorch, blocked);
  * ``"int8"``      — serving: Q/K/V quantized to int8 with absmax scales,
                      scores through the 32b->8b requant unit, the exp and
                      reciprocal LUTs in place of the softmax — the
                      hand-written kernels on the card, their plain versions
                      on the CPU.

A model trains with ``fakequant`` and serves with ``int8``.  The decode
entry points' ``float`` and ``fakequant`` modes are the reference's
baselines, the same in both modes: the int8 cache (the same contents in
every mode) dequantized with its static scales, then the float
safe-softmax under the length (and window) mask, plain PyTorch on any
device (the reference computes them outside its kernels too).

Two options of the int8 kernels, the reference's ablations, default off
and set by no config: ``lut_mode="compute"`` reads the exp values the
reference recomputes per element from a second table
(:func:`luts_for`), and ``exact_recip`` divides in the finalize instead
of reading the reciprocal LUT.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core import paged_kv
from repro_torch.core import quantization as qlib
from repro_torch.core.lut import LUTConfig
from repro_torch.kernels import blocked as blocked_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ref as ref_lib

MODES = ("float", "fakequant", "int8")
LUT_MODES = ("onehot", "compute")
FAKEQUANT_BLOCK_K = 512


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Static attention configuration."""
    mode: str = "fakequant"            # float | fakequant | int8
    scale_z: float = 8.0 / 127         # score quant scale (clip ~ +-8)
    window: Optional[int] = None       # sliding-window size, None = full
    causal: bool = True                # full-sequence attention only
    fused: bool = True                 # decode: in-kernel quantize of q
    lut_mode: str = "onehot"           # onehot | compute: the int8 exp table
    exact_recip: bool = False          # int8 finalize: 1/s, not the LUT
    # training perf levers (defaults = the paper-faithful baseline)
    score_dtype: str = "float32"       # float32 | bfloat16 score chain
    triangular: bool = False           # causal triangular chunk schedule

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"attention mode {self.mode!r}, not in {MODES}")
        if self.lut_mode not in LUT_MODES:
            raise ValueError(f"lut_mode {self.lut_mode!r}, not in "
                             f"{LUT_MODES}")

    @property
    def lut_config(self) -> LUTConfig:
        return LUTConfig(scale_z=self.scale_z)


@functools.lru_cache(maxsize=32)
def luts_for(scale_z: float, device: torch.device, lut_mode: str = "onehot"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(exp LUT, recip LUT) as int32 tensors on ``device``; with
    ``lut_mode="compute"`` the exp table holds the reference's per-element
    f32 recompute (``lut.build_exp_lut_compute``, built on the CPU)."""
    cfg = LUTConfig(scale_z=scale_z)
    exp_lut = (lut_lib.build_exp_lut_compute(cfg) if lut_mode == "compute"
               else torch.from_numpy(lut_lib.build_exp_lut(cfg)))
    return (exp_lut.to(device),
            torch.from_numpy(lut_lib.build_recip_lut(cfg)).to(device))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              spec: AttentionSpec, *, kv_valid_len: Optional[int] = None
              ) -> torch.Tensor:
    """(B,Hq,Sq,D) x (B,Hkv,Sk,D) -> (B,Hq,Sq,D), dtype of q, in the mode
    ``spec.mode``: causal unless ``spec.causal`` is False (the encoder and
    cross attention), keys at or past ``kv_valid_len`` masked.  Float
    inputs; int8 calibrates q, k and v with per-tensor absmax scales
    (constants: the int8 path takes no gradient).  Fakequant runs over k
    chunks of ``FAKEQUANT_BLOCK_K`` (the reference's ``max(spec.block_k,
    512)`` with its one ``block_k``), which must divide Sk when Sk is
    longer.  The float mode honours ``kv_valid_len`` too, which the
    reference's drops (no caller passes it; ROADMAP queue 3)."""
    if hasattr(q, "device_mesh"):               # DTensors on a mesh
        return _attention_per_rank(q, k, v, spec, kv_valid_len)
    causal = spec.causal
    if spec.mode == "float":
        mask = None
        if kv_valid_len is not None:
            mask = torch.arange(k.shape[2], device=q.device) < kv_valid_len
        out = ref_lib.safe_softmax_attention_ref(q, k, v, causal=causal,
                                                 window=spec.window,
                                                 mask=mask)
        return out.to(q.dtype)
    if spec.mode == "fakequant":
        out = blocked_lib.blocked_fakequant_attention(
            q, k, v, spec.lut_config, causal=causal, window=spec.window,
            kv_valid_len=kv_valid_len, block_k=FAKEQUANT_BLOCK_K,
            score_dtype=getattr(torch, spec.score_dtype),
            triangular=spec.triangular)
        return out.to(q.dtype)
    q, k, v = q.detach(), k.detach(), v.detach()
    s_q = qlib.absmax_scale(q)
    s_k = qlib.absmax_scale(k)
    s_v = qlib.absmax_scale(v)
    exp_lut, recip_lut = luts_for(spec.scale_z, q.device, spec.lut_mode)
    out = ops.splitmax_attention(
        qlib.quantize(q, s_q), qlib.quantize(k, s_k), qlib.quantize(v, s_v),
        s_q, s_k, s_v, exp_lut, recip_lut, cfg=spec.lut_config,
        causal=causal, window=spec.window, kv_valid_len=kv_valid_len,
        exact_recip=spec.exact_recip)
    return out.to(q.dtype)


def _attention_per_rank(q, k, v, spec: AttentionSpec,
                        kv_valid_len: Optional[int]) -> torch.Tensor:
    """:func:`attention` of DTensors: every mode is independent across the
    batch and the (GQA groups of) heads, so each rank runs it on its own
    rows and heads (``dist.sharding.per_rank``, laid out as ``q`` is).
    The int8 mode's per-tensor scales are the whole tensors' absmax,
    reduced over the mesh first, then passed in whole."""
    from repro_torch.dist.sharding import per_rank
    rows_heads = {0: 0, 1: 1}
    if spec.mode != "int8":
        return per_rank(
            lambda q, k, v: attention(q, k, v, spec,
                                      kv_valid_len=kv_valid_len),
            q, (q, k, v), (rows_heads,) * 3, rows_heads)
    q, k, v = q.detach(), k.detach(), v.detach()
    s_q, s_k, s_v = (qlib.absmax_scale(t) for t in (q, k, v))
    exp_lut, recip_lut = luts_for(spec.scale_z, q.device, spec.lut_mode)

    def local(q_q, k_q, v_q, s_q, s_k, s_v):
        return ops.splitmax_attention(
            q_q, k_q, v_q, s_q, s_k, s_v, exp_lut, recip_lut,
            cfg=spec.lut_config, causal=spec.causal, window=spec.window,
            kv_valid_len=kv_valid_len, exact_recip=spec.exact_recip)

    out = per_rank(local, q,
                   (qlib.quantize(q, s_q), qlib.quantize(k, s_k),
                    qlib.quantize(v, s_v), s_q, s_k, s_v),
                   (rows_heads,) * 3 + ({},) * 3, rows_heads)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache_q: torch.Tensor,
                     v_cache_q: torch.Tensor, s_k: torch.Tensor,
                     s_v: torch.Tensor, cache_len: torch.Tensor,
                     spec: AttentionSpec) -> torch.Tensor:
    """(B,Hq,D) query vs the dense int8 cache (B,Hkv,S_max,D) -> (B,Hq,D),
    dtype of q.  One ``s_q`` per slot, as in :func:`paged_decode_attention`;
    ``spec.fused`` picks the fused or the composed kernel.  The float and
    fakequant modes attend the dequantized cache's first ``cache_len``
    positions (and, with a window, only its last ``window``)."""
    if spec.mode in ("float", "fakequant"):
        kf = qlib.dequantize(k_cache_q, s_k)
        vf = qlib.dequantize(v_cache_q, s_v)
        kpos = torch.arange(kf.shape[2], device=q.device)[None, :]
        lens = cache_len.to(torch.int64)[:, None]
        valid = kpos < lens
        if spec.window is not None:
            valid &= kpos > lens - 1 - spec.window
        out = ref_lib.safe_softmax_attention_ref(
            q[:, :, None, :], kf, vf, causal=False,
            mask=valid[:, None, None, :])[:, :, 0, :]
        return out.to(q.dtype)
    if hasattr(q, "device_mesh"):
        # on a mesh the cache's sequence may be split over the axis the
        # heads are: the query whole over its heads, and DTensor reduces
        # the split softmax's sums over the sequence's shards
        from torch.distributed.tensor import Replicate, Shard
        q = q.redistribute(q.device_mesh, [
            p if p == Shard(0) else Replicate() for p in q.placements])
    s_q = qlib.absmax_scale(q, axis=(1, 2))                  # (B,1,1)
    exp_lut, recip_lut = luts_for(spec.scale_z, q.device, spec.lut_mode)
    if spec.fused:
        out = ops.splitmax_decode_fused(
            q, k_cache_q, v_cache_q, s_q, s_k, s_v, cache_len, exp_lut,
            recip_lut, cfg=spec.lut_config, window=spec.window,
            exact_recip=spec.exact_recip)
    else:
        out = ops.splitmax_decode(
            qlib.quantize(q, s_q), k_cache_q, v_cache_q, s_q, s_k, s_v,
            cache_len, exp_lut, recip_lut, cfg=spec.lut_config,
            window=spec.window, exact_recip=spec.exact_recip)
    return out.to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           s_k: torch.Tensor, s_v: torch.Tensor,
                           cache_len: torch.Tensor, spec: AttentionSpec
                           ) -> torch.Tensor:
    """(B,Hq,D) query vs the paged int8 pool -> (B,Hq,D), dtype of q.

    ``s_q`` is one scale per slot, the absmax of that slot's own query, so a
    slot's numerics never depend on its batch neighbours.  ``spec.fused``
    quantizes q inside the decode kernel; otherwise q is quantized here and
    the composed kernel takes the int8 query (the same values either way).
    The float and fakequant baselines gather the pool through the table
    and attend as :func:`decode_attention` does.
    """
    if spec.mode in ("float", "fakequant"):
        return decode_attention(q, paged_kv.gather_kv(k_pages, block_table),
                                paged_kv.gather_kv(v_pages, block_table),
                                s_k, s_v, cache_len, spec)
    s_q = qlib.absmax_scale(q, axis=(1, 2))                  # (B,1,1)
    exp_lut, recip_lut = luts_for(spec.scale_z, q.device, spec.lut_mode)
    if spec.fused:
        out = ops.splitmax_decode_fused_paged(
            q, k_pages, v_pages, block_table, s_q, s_k, s_v, cache_len,
            exp_lut, recip_lut, cfg=spec.lut_config, window=spec.window,
            exact_recip=spec.exact_recip)
    else:
        out = ops.splitmax_decode_paged(
            qlib.quantize(q, s_q), k_pages, v_pages, block_table, s_q, s_k,
            s_v, cache_len, exp_lut, recip_lut, cfg=spec.lut_config,
            window=spec.window, exact_recip=spec.exact_recip)
    return out.to(q.dtype)


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           s_k: torch.Tensor, s_v: torch.Tensor,
                           cache_len: torch.Tensor, spec: AttentionSpec
                           ) -> torch.Tensor:
    """(B,Hq,T,D) draft queries vs the paged int8 pool -> (B,Hq,T,D), dtype
    of q.

    All T tokens' K/V are already in the pool (``cache_len`` counts them)
    and query t attends ``cache_len - (T-1-t)`` positions.  ``s_q[b, t]`` is
    the absmax scale of slot b's token-t query, exactly the per-slot scale
    the sequential decode computes at that step.  The float and fakequant
    baselines run :func:`decode_attention` once per token over the
    gathered pool.
    """
    if spec.mode in ("float", "fakequant"):
        t = q.shape[2]
        k_all = paged_kv.gather_kv(k_pages, block_table)
        v_all = paged_kv.gather_kv(v_pages, block_table)
        outs = [decode_attention(q[:, :, i, :], k_all, v_all, s_k, s_v,
                                 cache_len - (t - 1 - i), spec)
                for i in range(t)]
        return torch.stack(outs, dim=2)
    s_q = qlib.absmax_scale(q, axis=(1, 3))[:, 0, :, 0]      # (B,T)
    exp_lut, recip_lut = luts_for(spec.scale_z, q.device, spec.lut_mode)
    out = ops.splitmax_decode_fused_verify_paged(
        q, k_pages, v_pages, block_table, s_q, s_k, s_v, cache_len,
        exp_lut, recip_lut, cfg=spec.lut_config, window=spec.window,
        exact_recip=spec.exact_recip)
    return out.to(q.dtype)
