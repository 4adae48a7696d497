"""int8 x int8 -> int32 GEMM with the optional fused requant epilogue: the
CUDA kernel's wrapper and its plain PyTorch version (port of
``repro/kernels/int8_matmul.py``).

``(M, K) int8 @ (K, N) int8 -> (M, N) int32``, or, given a scalar f32
``multiplier``, ``clip(round(f32(acc) * multiplier), -128, 127)`` as int8 --
the 32b -> 8b quantization unit applied before the result leaves the
kernel.  Any M, N, K: the kernel masks ragged edges.

As in the reference, no model calls it: the port's linear layers compute
in the model's float dtype (``models/layers.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import quantization as qlib
from repro_torch.kernels import cuda_build

# Launches of the CUDA kernel since the last reset (plain versions and CPU
# calls never count).
launches = 0

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("int8_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul_launch.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.int8_matmul_launch.restype = i
        lib.int8_matmul_error_string.argtypes = [i]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      multiplier: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  The int32 sums are formed
    as an f64 matmul, exact here (|acc| <= K * 2^14 < 2^53) and available
    on the card, which has no integer matmul."""
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    if multiplier is None:
        return acc
    return qlib.requantize_int32(acc, multiplier.to(torch.float32))


def int8_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor,
                     multiplier: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Launch the int8 GEMM kernel; raises on bad input or a refused
    launch."""
    global launches
    if not x_q.is_cuda:
        raise ValueError("int8_matmul_cuda takes CUDA tensors")
    for name, t in (("x_q", x_q), ("w_q", w_q)):
        if (t.device != x_q.device or t.dtype != torch.int8 or t.dim() != 2
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous 2-D int8 tensor on "
                             f"{x_q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    m, k = x_q.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"x_q {tuple(x_q.shape)} @ w_q {tuple(w_q.shape)}")
    if multiplier is not None:
        if (multiplier.device != x_q.device or multiplier.numel() != 1
                or multiplier.dtype != torch.float32):
            raise ValueError("multiplier: need one f32 value on the card")
        multiplier = multiplier.contiguous()
    out = torch.empty((m, n), device=x_q.device,
                      dtype=torch.int32 if multiplier is None else torch.int8)
    if out.numel() == 0:
        return out
    vec_ok = int(k % 16 == 0 and n % 4 == 0 and x_q.data_ptr() % 16 == 0
                 and w_q.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.int8_matmul_launch(
            x_q.data_ptr(), w_q.data_ptr(),
            None if multiplier is None else multiplier.data_ptr(),
            out.data_ptr(), m, n, k, vec_ok, stream)
    if err:
        raise RuntimeError("int8_matmul_launch failed: "
                           + lib.int8_matmul_error_string(err).decode())
    launches += 1
    return out
