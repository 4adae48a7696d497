"""Multi-head attention block wired to the CIMple datapath (port of
``repro/models/attention.py``: projections, the full-sequence block of
training and of the encoder, the encoder-decoder's cross attention, the
dense cache and its decode block with the sliding-window ring buffer, the
paged pool, the paged decode block and the paged speculative-verify
block).

Projections run in the model's compute dtype; the score -> LUT softmax ->
PV epilogue runs through :mod:`repro_torch.core.attention`.  The KV cache
is int8 with static per-layer scales, either one dense ``(slots, max_len)``
row per slot or paged into a block pool.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from repro_torch.core import attention as core_attn
from repro_torch.core import paged_kv
from repro_torch.core import quantization as qlib
from repro_torch.dist.sharding import shard
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def split_heads(x: torch.Tensor, n: int, hd: int,
                groups: Optional[int] = None) -> torch.Tensor:
    """A projection ``(B, S, n * hd)`` -> ``(B, S, n, hd)``.  Under a mesh
    binding it is first laid out with whole heads on each rank, and with
    ``groups`` (the query heads of a GQA layer: its K/V head count) whole
    groups of them: its last dim is split over "model" only where that
    divides ``groups or n``.  DTensor splits no dim across a reshape that
    would cut a head, nor the attention's (Hkv, group) reshape of the
    query heads across a group."""
    b, s, _ = x.shape
    x = shard(x, "batch", None, "heads", sizes=(b, s, groups or n))
    return x.reshape(b, s, n, hd)


def _linear(params, x: torch.Tensor, dt: torch.dtype, tokenwise: bool
            ) -> torch.Tensor:
    """``layers.linear_apply``; ``tokenwise`` (the verify step) runs it one
    token at a time, at the decode step's shape (``layers.per_token``), its
    int8 weight dequantized once unless the decode step reads it int8
    (``layers.dequantized`` with the rows): a BLAS may sum a GEMM's rows in
    an order chosen by the row count (the CPU's f32 SGEMM does at 1 and 2
    rows against 8)."""
    if tokenwise:
        return L.per_token(functools.partial(
            L.linear_apply, L.dequantized(params, dt, rows=x.shape[0]),
            dtype=dt), x)
    return L.linear_apply(params, x, dtype=dt)


def out_proj(params, out: torch.Tensor, cfg: ModelConfig, *,
             tokenwise: bool = False) -> torch.Tensor:
    """The output projection ``wo`` of the heads' outputs ``(B, S, H*hd)``
    (one token at a time with ``tokenwise``, see :func:`_linear`).
    Under a mesh binding its partial sums over the head-sharded ``model``
    axis are reduced here: left partial, the norm that follows keeps them
    partial (it is linear in them), and DTensor then gathers the next
    weight whole rather than reduce them, repeating that product on every
    ``model`` rank."""
    return shard(_linear(params["wo"], out, cfg.compute_dtype, tokenwise),
                 "batch", None, "embed")


def attn_block_init(gen, cfg: ModelConfig, *, device,
                    dtype: torch.dtype = torch.float32,
                    d_input: Optional[int] = None) -> L.Params:
    """QKV + output projections (``dtype``: see ``layers.normal_init``),
    and the per-head q/k RMSNorms with ``cfg.qk_norm``.  The projections
    take ``d_input`` features (default ``d_model``; the hybrid's shared
    block reads concat(hidden, embeddings), 2 x d_model) and the output
    projection returns ``d_model``."""
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    d = d_input or cfg.d_model
    p = {
        "wq": L.linear_init(gen, d, hq * hd, device=device, dtype=dtype),
        "wk": L.linear_init(gen, d, hkv * hd, device=device, dtype=dtype),
        "wv": L.linear_init(gen, d, hkv * hd, device=device, dtype=dtype),
        "wo": L.linear_init(gen, hq * hd, cfg.d_model, device=device,
                            dtype=dtype,
                            std=(hq * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, device)
        p["k_norm"] = L.rmsnorm_init(hd, device)
    return p


def attn_block_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                     spec: Optional[core_attn.AttentionSpec] = None,
                     causal: bool = True) -> torch.Tensor:
    """Full-sequence attention block (training, the encoder): x (B, S, d)
    -> (B, S, d), attention in ``spec`` (default ``cfg.attn_spec()``, the
    training mode), bidirectional with ``causal=False``."""
    b, s, _ = x.shape
    spec = spec or cfg.attn_spec()
    if not causal:
        spec = dataclasses.replace(spec, causal=False)
    q, k, v = _project_qkv(params, x, cfg, torch.arange(s, device=x.device))
    out = core_attn.attention(q, k, v, spec)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    out = shard(out, "batch", None, "embed")
    return out_proj(params, out, cfg)


def cross_kv(params, memory: torch.Tensor, cfg: ModelConfig):
    """The encoder memory (B, S_enc, d) -> cross K, V (B, Hkv, S_enc, hd):
    projected, no RoPE."""
    b, sm, _ = memory.shape
    dt = cfg.compute_dtype
    k = L.linear_apply(params["wk"], memory, dtype=dt)
    v = L.linear_apply(params["wv"], memory, dtype=dt)
    return (split_heads(k, cfg.n_kv_heads, cfg.hd).transpose(1, 2),
            split_heads(v, cfg.n_kv_heads, cfg.hd).transpose(1, 2))


def cross_attn_apply(params, x: torch.Tensor, memory: torch.Tensor,
                     cfg: ModelConfig, *,
                     spec: Optional[core_attn.AttentionSpec] = None,
                     memory_valid_len: Optional[int] = None,
                     kv=None) -> torch.Tensor:
    """Cross attention of the decoder's x (B, S, d) over the encoder memory
    (B, S_enc, d): non-causal, no RoPE, keys past ``memory_valid_len``
    masked.  ``kv`` passes :func:`cross_kv`'s K and V when the caller has
    already computed them from ``memory``."""
    b, s, _ = x.shape
    dt = cfg.compute_dtype
    spec = dataclasses.replace(spec or cfg.attn_spec(), causal=False)
    q = L.linear_apply(params["wq"], x, dtype=dt)
    q = split_heads(q, cfg.n_heads, cfg.hd, cfg.n_kv_heads).transpose(1, 2)
    k, v = kv if kv is not None else cross_kv(params, memory, cfg)
    out = core_attn.attention(q, k, v, spec, kv_valid_len=memory_valid_len)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return out_proj(params, out, cfg)


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, *, tokenwise: bool = False):
    """x: (B, S, d) -> q (B,Hq,S,hd), k/v (B,Hkv,S,hd), roped; with
    ``cfg.qk_norm`` q and k are RMS-normed per head first.  The norms run
    on the contiguous (B, S, H, hd) heads (each row's mean is the same
    function as on the reference's transposed layout), and ``tokenwise``
    (the verify step) runs them one token at a time, at the decode step's
    shape (``layers.per_token``), as it does the q, k and v projections."""
    b, s, _ = x.shape
    dt = cfg.compute_dtype
    hd = cfg.hd
    q = _linear(params["wq"], x, dt, tokenwise)
    k = _linear(params["wk"], x, dt, tokenwise)
    v = _linear(params["wv"], x, dt, tokenwise)
    q = split_heads(q, cfg.n_heads, hd, cfg.n_kv_heads)
    k = split_heads(k, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        def norm(p, y):
            if tokenwise:
                return L.per_token(functools.partial(L.rmsnorm_apply, p), y)
            return L.rmsnorm_apply(p, y)
        q = norm(params["q_norm"], q)
        k = norm(params["k_norm"], k)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = split_heads(v, cfg.n_kv_heads, hd).transpose(1, 2)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    # q's guard tests the K/V head count: whole GQA groups on each rank
    q = shard(q, "batch", "heads", None, None,
              sizes=(b, cfg.n_kv_heads, s, hd))
    k = shard(k, "batch", "heads", None, None)
    v = shard(v, "batch", "heads", None, None)
    return q, k, v


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                  n_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Stacked-by-layer dense int8 cache ``(L, B, Hkv, max_len, hd)`` of
    ``n_layers`` attention layers (default ``cfg.n_layers``; the hybrid's
    shared block has one a group).  ``scale_k``/``scale_v`` are static
    per-layer scales, fixed at prefill (calibration) time."""
    nl = n_layers or cfg.n_layers
    shape = (nl, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {
        "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
        "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
        "scale_k": torch.full((nl, 1, 1, 1, 1), 1e-2, dtype=torch.float32,
                              device=device),
        "scale_v": torch.full((nl, 1, 1, 1, 1), 1e-2, dtype=torch.float32,
                              device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def attn_block_decode(params, x: torch.Tensor,
                      layer_cache: Dict[str, torch.Tensor],
                      cfg: ModelConfig) -> torch.Tensor:
    """One-token decode against one layer's slice of the dense cache.

    ``layer_cache``: views ``k_q``/``v_q`` (B, Hkv, S, hd), scalar scales and
    ``length`` (B,) before this token.  The new token's K/V are quantized
    with the static scales and written **in place** at its position, then
    the query attends over the cache.  With a window the cache is a ring
    of ``S`` (== window) positions: the write goes to ``(len-1) % S``, the
    query attends ``min(len, S)`` positions and no window mask is applied
    at score time.  Without one, a write at a position >= S is dropped, as
    the reference's out-of-bounds scatter is.
    """
    b = x.shape[0]
    spec = cfg.attn_spec(serve=True)
    k_q, v_q = layer_cache["k_q"], layer_cache["v_q"]
    cache_size = k_q.shape[2]
    new_len = layer_cache["length"] + 1            # includes current token
    positions = (new_len - 1)[:, None]             # (B, 1) absolute (RoPE)
    q, k, v = _project_qkv(params, x, cfg, positions)
    s_k = layer_cache["scale_k"].reshape(())
    s_v = layer_cache["scale_v"].reshape(())
    k_new = qlib.quantize(k[:, :, 0, :], s_k)      # (B, Hkv, hd)
    v_new = qlib.quantize(v[:, :, 0, :], s_v)
    if spec.window is not None:
        pos = ((new_len - 1) % cache_size).long()
        attn_len = torch.clamp_max(new_len, cache_size)
        spec = dataclasses.replace(spec, window=None)
    else:
        pos = (new_len - 1).long()
        attn_len = new_len
    write_token(k_q, k_new, pos)
    write_token(v_q, v_new, pos)
    out = core_attn.decode_attention(q[:, :, 0, :], k_q, v_q, s_k, s_v,
                                     attn_len, spec)
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd)
    return out_proj(params, out, cfg)


def write_token(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
                ) -> None:
    """``cache[b, :, pos[b]] = new[b]`` in place, for ``cache (B, H, S, hd)``
    and ``new (B, H, hd)``; a position >= S is dropped.

    A DTensor cache (batch and sequence sharded by ``cache_shardings``) is
    written shard by shard: DTensor has no in-place ``index_put_`` on a
    sharded tensor, so ``new`` and ``pos`` take the cache's batch layout
    and each rank writes the positions that fall in its own sequence
    chunk into its local tensor."""
    offset = 0
    if hasattr(cache, "device_mesh"):
        from torch.distributed.tensor import Replicate, Shard
        mesh, pl = cache.device_mesh, cache.placements
        rows = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
        seq_len = cache.shape[2]
        for i, p in enumerate(pl):
            if p == Shard(2):
                seq_len //= mesh.size(i)
                offset = offset * mesh.size(i) + mesh.get_local_rank(i)
        offset *= seq_len
        new = new.redistribute(mesh, rows).to_local()
        pos = pos.redistribute(mesh, rows).to_local()
        cache = cache.to_local()
    size = cache.shape[2]
    pos = pos - offset
    inside = ((pos >= 0) & (pos < size))[:, None, None]
    pos = torch.clamp(pos, 0, size - 1)
    b_idx = torch.arange(cache.shape[0], device=cache.device)
    cache[b_idx, :, pos, :] = torch.where(inside, new,
                                          cache[b_idx, :, pos, :])


def init_paged_kv_cache(cfg: ModelConfig, num_blocks: int, slots: int,
                        blocks_per_slot: int, block_k: int, *, device
                        ) -> Dict[str, torch.Tensor]:
    """Stacked-by-layer paged int8 pool (see :mod:`repro_torch.core.paged_kv`)."""
    return paged_kv.init_kv_pages(cfg.n_layers, num_blocks, cfg.n_kv_heads,
                                  block_k, cfg.hd, slots, blocks_per_slot,
                                  device=device)


def attn_block_decode_paged(params, x: torch.Tensor,
                            layer_cache: Dict[str, torch.Tensor],
                            cfg: ModelConfig) -> torch.Tensor:
    """One-token decode against one layer's slice of the paged pool.

    ``layer_cache``: views ``k_pages``/``v_pages`` (num_blocks, Hkv,
    block_k, hd), scalar scales, ``block_table`` (B, max_blocks) and
    ``length`` (B,) before this token.  The new token's K/V are quantized
    with the static scales and written **in place** into the slot's tail
    block, then the query attends over ``length + 1`` positions.
    """
    b = x.shape[0]
    hd = cfg.hd
    table = layer_cache["block_table"]
    mb = table.shape[1]
    k_pages, v_pages = layer_cache["k_pages"], layer_cache["v_pages"]
    block_k = k_pages.shape[2]
    new_len = layer_cache["length"] + 1            # includes current token
    positions = (new_len - 1)[:, None]             # (B, 1) absolute (RoPE)
    q, k, v = _project_qkv(params, x, cfg, positions)
    s_k = layer_cache["scale_k"].reshape(())
    s_v = layer_cache["scale_v"].reshape(())
    # tail-block address; clamp so an over-run slot (retired but still
    # stepping) stays inside its table row
    pos = torch.clamp_max(new_len - 1, mb * block_k - 1).long()
    blk = table[torch.arange(b, device=table.device), pos // block_k].long()
    off = pos % block_k
    k_pages[blk, :, off, :] = qlib.quantize(k[:, :, 0, :], s_k)
    v_pages[blk, :, off, :] = qlib.quantize(v[:, :, 0, :], s_v)
    out = core_attn.paged_decode_attention(
        q[:, :, 0, :], k_pages, v_pages, table, s_k, s_v, new_len,
        cfg.attn_spec(serve=True))
    out = out.reshape(b, 1, cfg.n_heads * hd)
    return out_proj(params, out, cfg)


def attn_block_verify_paged(params, x: torch.Tensor,
                            layer_cache: Dict[str, torch.Tensor],
                            cfg: ModelConfig) -> torch.Tensor:
    """T-token speculative verify against one layer's slice of the pool.

    ``x (B, T, d)`` carries the T verify tokens (the last accepted token and
    the drafts).  Their K/V are quantized with the static scales and written
    **in place** through the table at positions ``length + t``; then all T
    queries attend in one verify launch, token t over ``length + t + 1``
    positions.  The T-token twin of :func:`attn_block_decode_paged`: the
    scheduler rolls rejected tokens back, never this function.
    """
    b, t, _ = x.shape
    table = layer_cache["block_table"]
    base_len = layer_cache["length"]
    positions = (base_len.to(torch.int64)[:, None]
                 + torch.arange(t, device=x.device)[None, :])   # (B, T)
    q, k, v = _project_qkv(params, x, cfg, positions, tokenwise=True)
    s_k = layer_cache["scale_k"].reshape(())
    s_v = layer_cache["scale_v"].reshape(())
    k_pages, v_pages = layer_cache["k_pages"], layer_cache["v_pages"]
    paged_kv.append_kv(k_pages, table, base_len,
                       qlib.quantize(k, s_k).transpose(1, 2))   # (B,T,Hkv,hd)
    paged_kv.append_kv(v_pages, table, base_len,
                       qlib.quantize(v, s_v).transpose(1, 2))
    out = core_attn.paged_verify_attention(
        q, k_pages, v_pages, table, s_k, s_v, base_len + t,
        cfg.attn_spec(serve=True))
    out = out.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.hd)
    return out_proj(params, out, cfg, tokenwise=True)
