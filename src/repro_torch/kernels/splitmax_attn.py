"""Split-softmax attention for prefill: the CUDA kernel's wrapper and its
plain PyTorch version (port of ``repro/kernels/splitmax_attn.py``).

Because the scores entering the softmax are int8-quantized, ``z_quant_max =
127`` bounds them and ``e^(z - 127) <= 1``: no running max is needed, and
the numerator ``acc = sum E[z_q] V`` and denominator ``s = sum E[z_q]``
accumulate in one pass, with one reciprocal-LUT multiply per row at the end.

Layouts: q (B, Hq, Sq, D) int8; k, v (B, Hkv, Sk, D) int8 (GQA: query head
h reads KV head ``h // (Hq // Hkv)``); output (B, Hq, Sq, D) f32.  ``Sq`` and
``Sk`` may be any length (the kernel masks the ragged edge).

The CUDA kernel sums ``e * v`` and ``e`` exactly in integers and converts
each to f32 once (``csrc/splitmax_common.cuh``).  The plain version's
default takes the f32 matmul of the reference; ``exact=True`` takes both
sums in f64, exact for these integers, and so gives the kernel's bits.
``exact_recip`` (both) divides by the denominator in place of the
reciprocal LUT: a compile-time variant of the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core import quantization as qlib
from repro_torch.core.lut import LUTConfig
from repro_torch.kernels import cuda_build

# Launches of the CUDA kernel since the last reset (plain versions and CPU
# calls never count).
launches = 0

# The kernel's byte split e = 256 * e_hi + e_lo keeps its two int32 sums
# exact up to this many attended keys (65535 * 255 * 128 < 2^31) and needs
# e <= 2^15 (kMaxExactKeys in csrc/splitmax_common.cuh).
MAX_EXACT_KEYS = 65535
MAX_EXP_FRAC_BITS = 15
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("splitmax_attn")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.splitmax_attention_launch.argtypes = [p] * 8 + [i] * 12 + [p]
        lib.splitmax_attention_launch.restype = i
        lib.splitmax_attention_error_string.argtypes = [i]
        lib.splitmax_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def attn_mask(sq: int, sk: int, *, causal: bool, window: Optional[int],
              kv_valid_len: int, device) -> torch.Tensor:
    """(sq, sk) bool, True = attend; rows and columns are absolute positions
    from 0, as in the reference."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos < kv_valid_len
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def splitmax_attention_plain(q_q, k_q, v_q, m_z, s_v, exp_lut, recip_lut, *,
                             cfg: LUTConfig, causal: bool = True,
                             window: Optional[int] = None,
                             kv_valid_len: Optional[int] = None,
                             exact_recip: bool = False,
                             exact: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch (materializes the scores).
    ``exact`` takes ``e @ v`` and ``e.sum`` in f64 (every partial sum is an
    integer below 2^53) and rounds each to f32 once: the CUDA kernel's
    accumulation contract, bit for bit."""
    b, hq, sq, d = q_q.shape
    _, hkv, sk, _ = k_q.shape
    g = hq // hkv
    kv_valid = sk if kv_valid_len is None else int(kv_valid_len)
    qg = q_q.reshape(b, hkv, g, sq, d).to(torch.float32)
    # int8 products are at most 2^14 and |z32| <= D * 2^14 <= 2^22, so every
    # partial sum is an integer below 2^24: this f32 matmul is exact in any
    # summation order (with TF32 off).
    z32 = qg @ k_q.to(torch.float32)[:, :, None].transpose(-1, -2)
    z_q = qlib.requantize_int32(z32, m_z)
    e = lut_lib.exp_lookup(z_q, exp_lut).to(torch.float32)
    mask = attn_mask(sq, sk, causal=causal, window=window,
                     kv_valid_len=kv_valid, device=q_q.device)
    e = torch.where(mask, e, 0.0)
    dt = torch.float64 if exact else torch.float32
    e = e.to(dt)
    acc = (e @ v_q.to(dt)[:, :, None]).to(torch.float32)      # (B,Hkv,G,Sq,D)
    r = lut_lib.recip_factor(e.sum(-1, keepdim=True), recip_lut, cfg,
                             exact_recip)
    out = acc * r * s_v
    return out.reshape(b, hq, sq, d)


def _check(q_q, k_q, v_q, m_z, s_v, exp_lut, recip_lut, cfg, kv_valid):
    dev = q_q.device
    for name, t, dt in (("q_q", q_q, torch.int8), ("k_q", k_q, torch.int8),
                        ("v_q", v_q, torch.int8), ("m_z", m_z, torch.float32),
                        ("s_v", s_v, torch.float32),
                        ("exp_lut", exp_lut, torch.int32),
                        ("recip_lut", recip_lut, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if q_q.dim() != 4 or k_q.dim() != 4 or k_q.shape != v_q.shape:
        raise ValueError(f"shapes q {tuple(q_q.shape)} k {tuple(k_q.shape)} "
                         f"v {tuple(v_q.shape)}")
    b, hq, _, d = q_q.shape
    if k_q.shape[0] != b or k_q.shape[3] != d or hq % k_q.shape[1]:
        raise ValueError(f"q {tuple(q_q.shape)} does not match k "
                         f"{tuple(k_q.shape)}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"head_dim {d}: the kernel takes a multiple of 16 "
                         f"in [16, 256]")
    if m_z.numel() != 1 or s_v.numel() != 1:
        raise ValueError("m_z and s_v are per-tensor scalars here")
    if exp_lut.numel() != 256 or recip_lut.numel() != cfg.recip_table_size:
        raise ValueError("LUT sizes do not match the LUTConfig")
    if kv_valid < 0:
        raise ValueError(f"kv_valid_len {kv_valid} < 0")
    if min(kv_valid, k_q.shape[2]) > MAX_EXACT_KEYS:
        raise ValueError(f"{min(kv_valid, k_q.shape[2])} attended keys: the "
                         f"kernel's integer sums are exact up to "
                         f"{MAX_EXACT_KEYS}")
    if cfg.exp_frac_bits > MAX_EXP_FRAC_BITS:
        raise ValueError(f"exp_frac_bits {cfg.exp_frac_bits}: the kernel's "
                         f"byte split of e needs e <= 2^{MAX_EXP_FRAC_BITS}")
    for name, t in (("q_q", q_q), ("k_q", k_q), ("v_q", v_q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def splitmax_attention_cuda(q_q, k_q, v_q, m_z, s_v, exp_lut, recip_lut, *,
                            cfg: LUTConfig, causal: bool = True,
                            window: Optional[int] = None,
                            kv_valid_len: Optional[int] = None,
                            exact_recip: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel (its ``exact_recip`` instance when asked) on
    PyTorch's current stream; raises on bad input or a refused launch."""
    global launches
    if not q_q.is_cuda:
        raise ValueError("splitmax_attention_cuda takes CUDA tensors")
    kv_valid = k_q.shape[2] if kv_valid_len is None else int(kv_valid_len)
    _check(q_q, k_q, v_q, m_z, s_v, exp_lut, recip_lut, cfg, kv_valid)
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    b, hq, sq, d = q_q.shape
    _, hkv, sk, _ = k_q.shape
    out = torch.empty((b, hq, sq, d), dtype=torch.float32, device=q_q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.splitmax_attention_launch(
            q_q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), m_z.data_ptr(),
            s_v.data_ptr(), exp_lut.data_ptr(), recip_lut.data_ptr(),
            out.data_ptr(), b, hq, hkv, sq, sk, d, kv_valid,
            int(causal), window or 0, cfg.recip_index_bits,
            cfg.recip_frac_bits, int(exact_recip), stream)
    if err:
        raise RuntimeError("splitmax_attention launch failed: "
                           + lib.splitmax_attention_error_string(err).decode())
    launches += 1
    return out
