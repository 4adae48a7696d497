"""Fused paged split-softmax decode: the CUDA kernel's wrapper and its plain
PyTorch version (port of ``repro/kernels/splitmax_decode.py``, the fused
paged entry only).

One new token per slot: the f32 query ``(B, Hq, D)`` is quantized with the
slot's own ``s_q`` and streams against the int8 pool ``(num_blocks, Hkv,
block_k, D)`` through the slot's block-table row, masked at ``cache_len``
(and the window), giving ``(B, Hq, D)`` f32.

Tiles whose table entry is the trash block (id 0) are dead.  A live slot
never has one inside its length (the allocator never hands out block 0), so
this changes nothing for live slots; an idle slot (length 0, row all trash)
gets an all-zero row, where the reference reads block 0 and returns
whatever it holds.  Idle rows are discarded by the scheduler either way.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core import paged_kv
from repro_torch.core import quantization as qlib
from repro_torch.core.lut import LUTConfig
from repro_torch.kernels import cuda_build

# Launches of the CUDA kernel since the last reset (plain versions and CPU
# calls never count).
launches = 0

THREADS = 128
MAX_OUT_PER_THREAD = 16       # kMaxOut in csrc/splitmax_common.cuh
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("splitmax_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.splitmax_decode_fused_paged_launch
        fn.argtypes = [p] * 11 + [i] * 9 + [p]
        fn.restype = i
        lib.splitmax_decode_error_string.argtypes = [i]
        lib.splitmax_decode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def live_positions(block_table, cache_len, block_k: int,
                   window: Optional[int]) -> torch.Tensor:
    """(B, max_blocks * block_k) bool: the cache positions a slot attends."""
    pos = torch.arange(block_table.shape[1] * block_k,
                       device=block_table.device)[None, :]
    lens = cache_len.to(torch.int64)[:, None]
    live = (pos < lens) & (block_table.repeat_interleave(block_k, dim=1)
                           != paged_kv.TRASH_BLOCK)
    if window is not None:
        live = live & (pos > lens - 1 - window)
    return live


def splitmax_decode_fused_paged_plain(q, k_pages, v_pages, block_table, m_z,
                                      s_q, s_v, cache_len, exp_lut, recip_lut,
                                      *, cfg: LUTConfig,
                                      window: Optional[int] = None
                                      ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: quantize, gather the cache
    through the table, then the grouped int8 split-softmax decode.
    ``m_z`` and ``s_q`` are per-slot ``(B,)``."""
    b, hq, d = q.shape
    _, hkv, bk, _ = k_pages.shape
    g = hq // hkv
    q_q = qlib.quantize(q, s_q[:, None, None])
    k_c = paged_kv.gather_kv(k_pages, block_table).to(torch.float32)
    v_c = paged_kv.gather_kv(v_pages, block_table).to(torch.float32)
    # exact f32 integer dot products (|z32| <= D * 2^14 < 2^24)
    z32 = q_q.reshape(b, hkv, g, d).to(torch.float32) @ k_c.transpose(-1, -2)
    z_q = qlib.requantize_int32(z32, m_z[:, None, None, None])
    e = lut_lib.exp_lookup(z_q, exp_lut).to(torch.float32)   # (B,Hkv,G,S)
    live = live_positions(block_table, cache_len, bk, window)
    e = torch.where(live[:, None, None, :], e, 0.0)
    acc = e @ v_c                                            # (B,Hkv,G,D)
    s = torch.clamp_min(e.sum(-1, keepdim=True), 1.0)
    r, ex = lut_lib.recip_lookup(s, recip_lut, cfg)
    out = acc * (r.to(torch.float32) * lut_lib.exp2_int(ex)) * s_v
    return out.reshape(b, hq, d)


def _check(q, k_pages, v_pages, block_table, m_z, s_q, s_v, cache_len,
           exp_lut, recip_lut, cfg):
    dev = q.device
    for name, t, dt in (("q", q, torch.float32), ("k_pages", k_pages, torch.int8),
                        ("v_pages", v_pages, torch.int8),
                        ("block_table", block_table, torch.int32),
                        ("m_z", m_z, torch.float32), ("s_q", s_q, torch.float32),
                        ("s_v", s_v, torch.float32),
                        ("cache_len", cache_len, torch.int32),
                        ("exp_lut", exp_lut, torch.int32),
                        ("recip_lut", recip_lut, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    b, hq, d = q.shape
    _, hkv, _, dk = k_pages.shape
    if dk != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pages "
                         f"{tuple(k_pages.shape)}")
    if d % 16 or (hq // hkv) * d > THREADS * MAX_OUT_PER_THREAD:
        raise ValueError(f"head_dim {d} x group {hq // hkv}: the kernel takes "
                         f"a multiple of 16 with group * D <= "
                         f"{THREADS * MAX_OUT_PER_THREAD}")
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table {tuple(block_table.shape)} for {b} slots")
    if m_z.shape != (b,) or s_q.shape != (b,) or cache_len.shape != (b,) \
            or s_v.numel() != 1:
        raise ValueError("m_z, s_q and cache_len are per-slot (B,); s_v a scalar")
    if exp_lut.numel() != 256 or recip_lut.numel() != cfg.recip_table_size:
        raise ValueError("LUT sizes do not match the LUTConfig")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def splitmax_decode_fused_paged_cuda(q, k_pages, v_pages, block_table, m_z,
                                     s_q, s_v, cache_len, exp_lut, recip_lut,
                                     *, cfg: LUTConfig,
                                     window: Optional[int] = None
                                     ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; raises on bad
    input or a refused launch.  ``q`` is f32; table ids must lie in the pool
    (the scheduler's allocator guarantees it)."""
    global launches
    if not q.is_cuda:
        raise ValueError("splitmax_decode_fused_paged_cuda takes CUDA tensors")
    _check(q, k_pages, v_pages, block_table, m_z, s_q, s_v, cache_len,
           exp_lut, recip_lut, cfg)
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    b, hq, d = q.shape
    _, hkv, bk, _ = k_pages.shape
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.splitmax_decode_fused_paged_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), m_z.data_ptr(), s_q.data_ptr(),
            s_v.data_ptr(), cache_len.data_ptr(), exp_lut.data_ptr(),
            recip_lut.data_ptr(), out.data_ptr(), b, hq, hkv, d, bk,
            block_table.shape[1], window or 0, cfg.recip_index_bits,
            cfg.recip_frac_bits, stream)
    if err:
        raise RuntimeError("splitmax_decode_fused_paged launch failed: "
                           + lib.splitmax_decode_error_string(err).decode())
    launches += 1
    return out
