"""The int8 GEMM of the port (the plain version of ``csrc/int8_matmul.cu``)
against ``repro.kernels.ops.int8_matmul(impl="ref")``: the int32 product
and the fused requant to int8 are integer results, so they must be equal,
bit for bit, on the reference's shapes (``tests/test_kernels.py``), a
ragged one, and K = 2048, where |acc| passes 2^24 and the int32 -> f32
conversion of the requant epilogue rounds.  The CUDA kernel is held against
this plain version in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

The card runs it as a K-major pre-pass (``w_q`` (K, N) -> ``w_t`` (N, Kp),
Kp = K rounded up to 16, pad columns zero) and a body that multiplies
K-major operands; ``pack_k_major_plain`` pins that layout and its padding
here: the zero-padded x times the packed w, summed in int64, equals the
reference bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import int8_matmul as K
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

SHAPES = [
    # m, k, n
    (256, 512, 256),
    (128, 128, 128),
    (512, 256, 384),
    (37, 100, 70),        # ragged on every edge
    (16, 2048, 24),       # |acc| past 2^24
]


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    if k >= 2048:
        # all-extreme rows and columns push |acc| to K * 2^14 = 2^25
        x[0], w[:, 0] = -128, -128
        x[1], w[:, 1] = 127, -128
    return x, w


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_plain_equals_reference(m, k, n):
    x, w = _operands(m + k + n, m, k, n)
    want = np.asarray(jops.int8_matmul(x, w, impl="ref"))
    got = tops.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    if k >= 2048:
        assert np.abs(want).max() > 2 ** 24


@pytest.mark.parametrize("mult", [3.7e-4, 1.1e-6, 2.9e-2])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_requant_plain_equals_reference(m, k, n, mult):
    x, w = _operands(m * k + n, m, k, n)
    want = np.asarray(jops.int8_matmul(x, w, jnp.float32(mult), impl="ref"))
    got = tops.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           torch.tensor(mult, dtype=torch.float32))
    assert got.dtype == torch.int8 and want.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_matmul_requant_rounds_half_to_even():
    """acc * m landing exactly on .5 rounds to even, as jnp.round does."""
    x = torch.tensor([[1], [3], [5], [-3]], dtype=torch.int8)
    w = torch.tensor([[1]], dtype=torch.int8)
    got = K.int8_matmul_plain(x, w, torch.tensor(0.5))
    want = np.asarray(jops.int8_matmul(x.numpy(), w.numpy(), jnp.float32(0.5),
                                       impl="ref"))
    assert got.flatten().tolist() == [0, 2, 2, -2] == want.flatten().tolist()


def test_int8_matmul_cuda_refuses_cpu_tensors():
    x = torch.zeros((4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        K.int8_matmul_cuda(x, x)


def _kmajor_product(x, w):
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    w_t = K.pack_k_major_plain(w)
    x_pad = torch.zeros((x.shape[0], w_t.shape[1]), dtype=torch.int8)
    x_pad[:, :x.shape[1]] = x
    return (x_pad.to(torch.int64) @ w_t.to(torch.int64).T).numpy()


@pytest.mark.parametrize("m,k,n", SHAPES + [(33, k, 40) for k in
                                            (1, 15, 16, 100, 129)])
def test_int8_matmul_kmajor_layout_equals_reference(m, k, n):
    x, w = _operands(m + 2 * k + n, m, k, n)
    x[0], w[:, 0] = -128, -128
    want = np.asarray(jops.int8_matmul(x, w, impl="ref"))
    np.testing.assert_array_equal(_kmajor_product(x, w), want)


@pytest.mark.parametrize("k", [1, 15, 16, 100, 129])
def test_pack_k_major_plain_layout(k):
    n = 21
    _, w = _operands(k, 1, k, n)
    w_t = K.pack_k_major_plain(torch.from_numpy(w))
    kp = -(-k // 16) * 16
    assert w_t.dtype == torch.int8 and w_t.shape == (n, kp) == (n, K.padded_k(k))
    assert w_t.is_contiguous() and w_t.stride(0) % 16 == 0
    np.testing.assert_array_equal(w_t[:, :k].numpy(), w.T)
    assert not w_t[:, k:].any()
