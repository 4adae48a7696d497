"""int8 x int8 -> int32 GEMM with the optional fused requant epilogue: the
CUDA kernel's wrapper and its plain PyTorch version (port of
``repro/kernels/int8_matmul.py``).

``(M, K) int8 @ (K, N) int8 -> (M, N) int32``, or, given a scalar f32
``multiplier``, ``clip(round(f32(acc) * multiplier), -128, 127)`` as int8 --
the 32b -> 8b quantization unit applied before the result leaves the
kernel.  Any M, N, K: the kernel masks ragged edges.

On the card it is two launches: a pre-pass that writes ``w_q`` K-major as
``(N, Kp)``, Kp = K rounded up to 16 (``pack_k_major_cuda``; 8-bit
``wgmma`` takes both operands K-major), then the TMA-fed int8 ``wgmma``
body (``int8_matmul_packed_cuda``).  The body raises its dynamic shared
memory limit at its first launch, so call it once before capturing it in
a CUDA graph.

As in the reference, no model calls it: the port's linear layers compute
in the model's float dtype (``models/layers.py``).  Its caller is the CIM
datapath model (``core/cim.py``), whose nibble and bit products are int8
GEMMs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import quantization as qlib
from repro_torch.kernels import cuda_build

# Kernel launches since the last reset, each counted where it is made:
# the GEMM body's (``int8_matmul_packed_cuda``, also reached through
# ``int8_matmul_cuda``) and the K-major pre-pass's (``pack_k_major_cuda``).
# Plain versions, CPU calls and empty outputs launch nothing and never count.
launches = 0
pack_launches = 0

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("int8_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_pack_k_major_launch.argtypes = [p, p] + [i] * 4 + [p]
        lib.int8_pack_k_major_launch.restype = i
        lib.int8_matmul_kmajor_launch.argtypes = [p] * 4 + [i] * 3 + [p]
        lib.int8_matmul_kmajor_launch.restype = i
        lib.int8_matmul_error_string.argtypes = [i]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: "
                           + lib.int8_matmul_error_string(err).decode())


def padded_k(k: int) -> int:
    """K rounded up to 16: a K-major row pitch that TMA takes."""
    return -(-k // 16) * 16


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


def pack_k_major_plain(w_q: torch.Tensor) -> torch.Tensor:
    """The pre-pass in plain PyTorch: ``w_q`` (K, N) -> ``w_t`` (N, Kp),
    K-major, zeros in columns K..Kp."""
    k, n = w_q.shape
    w_t = torch.zeros((n, padded_k(k)), dtype=w_q.dtype, device=w_q.device)
    w_t[:, :k] = w_q.t()
    return w_t


def _check_int8(name: str, t: torch.Tensor, device) -> None:
    if (t.device != device or t.dtype != torch.int8 or t.dim() != 2
            or not t.is_contiguous()):
        raise ValueError(f"{name}: need a contiguous 2-D int8 tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def pack_k_major_cuda(w_q: torch.Tensor) -> torch.Tensor:
    """Launch the pre-pass: ``w_q`` (K, N) on the card -> ``w_t`` (N, Kp)."""
    global pack_launches
    if not w_q.is_cuda:
        raise ValueError("pack_k_major_cuda takes a CUDA tensor")
    _check_int8("w_q", w_q, w_q.device)
    k, n = w_q.shape
    w_t = torch.empty((n, padded_k(k)), dtype=torch.int8, device=w_q.device)
    if w_t.numel() == 0:
        return w_t
    vec_ok = int(n % 4 == 0 and w_q.data_ptr() % 4 == 0)
    lib = _lib()
    with torch.cuda.device(w_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.int8_pack_k_major_launch(w_q.data_ptr(), w_t.data_ptr(), k,
                                           n, w_t.shape[1], vec_ok, stream)
    _check(lib, err, "int8_pack_k_major_launch")
    pack_launches += 1
    return w_t


def int8_matmul_packed_cuda(x_p: torch.Tensor, w_t: torch.Tensor,
                            multiplier: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Launch the GEMM body on K-major operands: ``x_p`` (M, Kp) @
    ``w_t`` (N, Kp)^T, Kp a multiple of 16, both bases 16-byte aligned, any
    pad columns zero (``pack_k_major_cuda``'s output)."""
    global launches
    if not x_p.is_cuda:
        raise ValueError("int8_matmul_packed_cuda takes CUDA tensors")
    for name, t in (("x_p", x_p), ("w_t", w_t)):
        _check_int8(name, t, x_p.device)
        if t.shape[1] % 16 or t.data_ptr() % 16:
            raise ValueError(f"{name}: need Kp % 16 == 0 and a 16-byte "
                             f"aligned base, got {tuple(t.shape)}")
    m, kp = x_p.shape
    n = w_t.shape[0]
    if w_t.shape[1] != kp:
        raise ValueError(f"x_p {tuple(x_p.shape)} @ w_t {tuple(w_t.shape)}^T")
    if multiplier is not None:
        if (multiplier.device != x_p.device or multiplier.numel() != 1
                or multiplier.dtype != torch.float32):
            raise ValueError("multiplier: need one f32 value on the card")
        multiplier = multiplier.contiguous()
    out = torch.empty((m, n), device=x_p.device,
                      dtype=torch.int32 if multiplier is None else torch.int8)
    if out.numel() == 0:
        return out
    if kp == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(x_p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.int8_matmul_kmajor_launch(
            x_p.data_ptr(), w_t.data_ptr(),
            None if multiplier is None else multiplier.data_ptr(),
            out.data_ptr(), m, n, kp, stream)
    _check(lib, err, "int8_matmul_kmajor_launch")
    launches += 1
    return out


def int8_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor,
                     multiplier: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The GEMM on the card: the K-major pre-pass of ``w_q``, then the
    TMA/wgmma body (each counted by its own wrapper; neither launches for
    an empty output); raises on bad input or a refused launch."""
    if not x_q.is_cuda:
        raise ValueError("int8_matmul_cuda takes CUDA tensors")
    _check_int8("x_q", x_q, x_q.device)
    _check_int8("w_q", w_q, x_q.device)
    if x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"x_q {tuple(x_q.shape)} @ w_q {tuple(w_q.shape)}")
    return int8_matmul_packed_cuda(_k_major_x(x_q), _packed_w(w_q, [x_q]),
                                   multiplier)


def int8_matmul_shared_w_cuda(xs, w_q: torch.Tensor) -> list:
    """Several ``(M_i, K)`` int8 operands on the card times one ``w_q (K,
    N)`` -> their int32 products: one K-major pre-pass of ``w_q``, then one
    GEMM body launch a product (each counted by its wrapper)."""
    _check_int8("w_q", w_q, w_q.device)
    for x_q in xs:
        _check_int8("x_q", x_q, w_q.device)
        if x_q.shape[1] != w_q.shape[0]:
            raise ValueError(f"x_q {tuple(x_q.shape)} @ w_q "
                             f"{tuple(w_q.shape)}")
    w_t = _packed_w(w_q, xs)
    return [int8_matmul_packed_cuda(_k_major_x(x_q), w_t) for x_q in xs]


def _k_major_x(x_q: torch.Tensor) -> torch.Tensor:
    """``x_q`` as the body's (M, Kp) operand: itself, or a zero-padded
    copy when K % 16 != 0 or its base is not 16-byte aligned."""
    m, k = x_q.shape
    if k % 16 == 0 and x_q.data_ptr() % 16 == 0:
        return x_q
    x_p = torch.zeros((m, padded_k(k)), dtype=torch.int8, device=x_q.device)
    x_p[:, :k] = x_q
    return x_p


def _packed_w(w_q: torch.Tensor, xs) -> torch.Tensor:
    """``w_q`` K-major through the pre-pass, or, when every output is empty
    (no x has rows), an empty stand-in without a launch."""
    k, n = w_q.shape
    if any(x_q.shape[0] for x_q in xs):
        return pack_k_major_cuda(w_q)
    return torch.empty((n, padded_k(k)), dtype=torch.int8, device=w_q.device)
