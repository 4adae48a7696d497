"""The int8-weight linear of a decode step: ``x (M, K) bf16 @ bf16(f32(w_q)
* w_s)`` with ``w_q (K, N)`` int8 and one f32 scale, summed in f32 -- the
CUDA kernel's wrapper (``csrc/w8_linear.cu``) and its plain PyTorch
version.

No TPU kernel stands behind it: the reference dequantizes and multiplies
in two XLA ops.  On the card the kernel reads ``w_q`` once and dequantizes
it in registers to the bits ``models/layers.py::linear_weight`` writes, in
place of that bf16 weight and cuBLAS.  It takes 1 to 64 rows (the
kernel's ``kMaxRows``) and K, N multiples of 16 (:func:`takes`).

Where each term of a sum goes depends on (K, N) alone: K is split over
blocks by :func:`split_rows`, and the splits' f32 partials are added in
split order by a second launch (``w8_linear_reduce_kernel``), so a row's
bits do not depend on how many rows came with it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import cuda_build

# Kernel launches since the last reset, one a call (the second launch that
# adds a split K's partials is part of the call).  The plain version
# launches nothing and never counts.
launches = 0

# K is split so that about this many blocks of 128 columns run: a constant
# of the kernel, not read from the card, so the split is one of (K, N).
TARGET_BLOCKS = 256
MIN_SPLIT_STAGES = 4           # 64-row stages a split holds at least

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("w8_linear")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w8_linear_launch.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.w8_linear_launch.restype = i
        lib.w8_linear_error_string.argtypes = [i]
        lib.w8_linear_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def takes(k: int, n: int) -> bool:
    """Whether the kernel takes a ``(K, N)`` weight."""
    return k >= 16 and n >= 16 and k % 16 == 0 and n % 16 == 0


@functools.lru_cache(maxsize=None)
def split_rows(k: int, n: int) -> int:
    """The rows of K one block sums, a multiple of 64: about
    ``TARGET_BLOCKS`` blocks over N's 128-column tiles, each split at least
    ``MIN_SPLIT_STAGES`` stages of 64 rows.  A function of (K, N) alone."""
    tiles = -(-n // 128)
    stages = -(-k // 64)
    want = max(1, min(-(-TARGET_BLOCKS // tiles), stages // MIN_SPLIT_STAGES))
    return 64 * -(-stages // want)


def w8_linear_plain(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor
                    ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the weight dequantized as
    ``linear_weight`` does (``f32(w_q) * w_s`` stored into bf16), then
    ``x @ w``."""
    w = torch.mul(w_q, w_s, out=torch.empty(w_q.shape, dtype=torch.bfloat16,
                                            device=w_q.device))
    return x.to(torch.bfloat16) @ w


def launch(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor
           ) -> torch.Tensor:
    """Launch the kernel on ``x (..., K)`` bf16 through ``w_q (K, N)`` int8
    and ``w_s (1, 1)`` f32 on ``x``'s card -> ``(..., N)`` bf16, for a
    caller that has proven the dtypes, the device and ``x``'s K
    (``layers.w8_kernel_takes``): a decode step makes hundreds of these
    calls, and the host's time a call is the step's.  ``x`` is copied
    where it is not contiguous or 16-byte aligned; raises where ``w_q`` is
    not, or where the kernel refuses the shape (1 to 64 rows, K and N
    multiples of 16) or the launch."""
    global launches
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    if not w_q.is_contiguous() or w_q.data_ptr() % 16:
        raise ValueError("w8_linear: w_q needs a contiguous 16-byte aligned "
                         "(K, N) layout")
    k, n = w_q.shape
    m = x.numel() // k
    rows = split_rows(k, n)
    splits = -(-k // rows)
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.bfloat16,
                      device=x.device)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib, dev = _lib(), x.get_device()
    args = (x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), m, k, n, rows)
    if dev == torch.cuda.current_device():
        err = lib.w8_linear_launch(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = lib.w8_linear_launch(
                *args, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise (ValueError if err == -1 else RuntimeError)(
            f"w8_linear: x {tuple(x.shape)} @ w_q {tuple(w_q.shape)}: "
            + lib.w8_linear_error_string(err).decode())
    launches += 1
    return out


def w8_linear_cuda(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor
                   ) -> torch.Tensor:
    """:func:`launch` behind a full check of its inputs: ``x (..., K)``
    bf16, ``w_q (K, N)`` int8 and ``w_s (1, 1)`` f32, all contiguous on one
    card; raises ``ValueError`` on anything else, before any launch."""
    dev = x.get_device()
    if not (dev >= 0 and x.dtype == torch.bfloat16 and w_q.dtype == torch.int8
            and w_s.dtype == torch.float32 and w_q.get_device() == dev
            and w_s.get_device() == dev and w_q.dim() == 2
            and w_s.shape == (1, 1) and x.is_contiguous()
            and w_q.is_contiguous() and x.shape[-1] == w_q.shape[0]):
        raise ValueError(
            f"w8_linear_cuda: need contiguous CUDA tensors on one card, x "
            f"(..., K) bf16, w_q (K, N) int8, w_s (1, 1) f32; got x "
            f"{tuple(x.shape)} {x.dtype} on {x.device}, w_q "
            f"{tuple(w_q.shape)} {w_q.dtype} on {w_q.device}, w_s "
            f"{tuple(w_s.shape)} {w_s.dtype} on {w_s.device}")
    return launch(x, w_q, w_s)
