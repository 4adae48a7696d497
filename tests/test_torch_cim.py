"""The CIM datapath model, the pure-integer requant pipeline, the quantized
tensor pair and the LUT reads the port adds in this slice, against the JAX
reference on numpy-seeded inputs.

``tests/test_cim.py`` is mirrored case for case (the nibble-split and
bit-serial products bit for bit the direct int32 GEMM, and the JAX
model's own products; the capacity model's paper numbers), then the
requant cases of ``tests/test_quantization.py`` (the Q15 pipeline within
1 LSB of the float requant, and bit for bit JAX's pipeline), the
``QuantizedTensor`` round trip, ``exp_lookup_onehot`` (bit for bit the
reference's) and ``recip_float`` (the reference's table entry and
exponent; its float ``exp2`` is exact in torch, ~1e-6 off in XLA).  Every
product here is an integer result: the port's equals JAX's exactly.  On
the CPU the products run the int8 GEMM's plain version;
``tests/test_torch_cuda.py`` holds them through kernel 8 on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # image without hypothesis: deterministic fallback
    from _hypothesis_stub import given, settings, strategies as st

from repro.core import cim as jcim
from repro.core import lut as jlut
from repro.core import quantization as jq
from repro_torch.core import cim as tcim
from repro_torch.core import lut as tlut
from repro_torch.core import quantization as tq

torch.set_num_threads(1)


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def test_nibble_split_weights_reconstruct(rng):
    w = _i8(rng, (64,))
    msb, lsb = tcim.nibble_split_weights(torch.from_numpy(w))
    jmsb, jlsb = jcim.nibble_split_weights(jnp.asarray(w))
    assert np.array_equal(msb.numpy() * 16 + lsb.numpy(), w.astype(np.int32))
    assert np.all(lsb.numpy() >= 0) and np.all(lsb.numpy() < 16)
    assert np.array_equal(msb.numpy(), np.asarray(jmsb))
    assert np.array_equal(lsb.numpy(), np.asarray(jlsb))


@pytest.mark.parametrize("fn, shape", [
    ("nibble_split_matmul", (32, 48, 24)),
    ("serial_bit_matmul", (16, 32, 8)),
    ("nibble_split_matmul", (37, 1000, 130)),   # ragged, |acc| past 2^24
    ("serial_bit_matmul", (37, 1000, 130)),
])
def test_cim_products_bitexact(rng, fn, shape):
    m, k, n = shape
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    x[0], w[:, 0] = -128, -128                # the sign bit's extremes
    direct = x.astype(np.int32) @ w.astype(np.int32)
    got = getattr(tcim, fn)(torch.from_numpy(x), torch.from_numpy(w))
    want = getattr(jcim, fn)(jnp.asarray(x), jnp.asarray(w))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), direct)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn", ["nibble_split_matmul", "serial_bit_matmul"])
def test_cim_products_batched_x(rng, fn):
    """A batched x_q (..., K) runs as one 2-D GEMM and keeps its dims."""
    x, w = _i8(rng, (2, 3, 40)), _i8(rng, (40, 9))
    got = getattr(tcim, fn)(torch.from_numpy(x), torch.from_numpy(w))
    want = getattr(jcim, fn)(jnp.asarray(x), jnp.asarray(w))
    assert tuple(got.shape) == (2, 3, 9)
    assert np.array_equal(got.numpy(), np.asarray(want))


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=1, max_value=5),
       st.integers(min_value=1, max_value=7))
def test_nibble_matmul_property(m, k):
    rng = np.random.default_rng(m * 31 + k)
    x, w = _i8(rng, (m, k)), _i8(rng, (k, 3))
    direct = x.astype(np.int32) @ w.astype(np.int32)
    for fn in (tcim.nibble_split_matmul, tcim.serial_bit_matmul):
        assert np.array_equal(fn(torch.from_numpy(x),
                                 torch.from_numpy(w)).numpy(), direct)


def test_capacity_model_paper_numbers():
    c = tcim.CIMConfig()
    assert c.weights_resident == 4096       # a 32 kb array of int8 weights
    assert c.macs_per_cycle == 32 * 64      # 32 partitions x 64 active
    assert 0.1 < c.peak_tops < 1.0          # macro-level, at 0.85 V
    assert c.gemm_tiles(1, 4096, 64) == 64
    j = jcim.CIMConfig()
    for name in ("weights_resident", "macs_per_cycle", "peak_ops_per_cycle",
                 "peak_tops"):
        assert getattr(c, name) == getattr(j, name), name
    for shape in ((1, 4096, 64), (256, 8192, 22016), (7, 100, 3)):
        assert c.gemm_tiles(*shape) == j.gemm_tiles(*shape)
        assert c.gemm_cycles(*shape, act_sparsity=0.5) == \
            j.gemm_cycles(*shape, act_sparsity=0.5)


def test_sparsity_reduces_cycles():
    c = tcim.CIMConfig()
    dense = c.gemm_cycles(16, 512, 512)
    sparse = c.gemm_cycles(16, 512, 512, act_sparsity=0.875)
    assert abs(sparse / dense - 0.125) < 1e-9


# ---------------------------------------------------------------------------
# the requant unit's integer pipeline
# ---------------------------------------------------------------------------

MULTS = (0.001, 0.0117, 1e-5, 0.3, 0.5, 0.9999999, 1e-12)


@pytest.mark.parametrize("mult", MULTS)
def test_requant_params_q15_equal_reference(mult):
    got = [t.numpy() for t in tq.requant_params_q15(mult)]
    want = [np.asarray(t) for t in jq.requant_params_q15(jnp.float32(mult))]
    assert [g.dtype for g in got] == [np.int32, np.int32]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shift", [0, 1, 5, 15, 31, 32, 40])
def test_rounding_rshift_equal_reference(rng, shift):
    x = rng.integers(-2 ** 31, 2 ** 31, (256,)).astype(np.int32)
    x[:4] = [2 ** 31 - 1, -2 ** 31, 7, -7]      # the bias add wraps at the top
    got = tq.rounding_rshift(torch.from_numpy(x), shift).numpy()
    want = np.asarray(jq.rounding_rshift(jnp.asarray(x), jnp.int32(shift)))
    assert np.array_equal(got, want)


def test_requant_float_vs_bitexact(rng):
    """Within 1 LSB of the float requant for |acc| < 2^20 (the reference's
    range), and bit for bit JAX's pipeline there and at the int32 extremes,
    where the pre-shift's rounding bias wraps in both."""
    acc = rng.integers(-2 ** 20, 2 ** 20, (512,)).astype(np.int32)
    extremes = np.array([2 ** 31 - 1, -2 ** 31, 2 ** 30], np.int32)
    for mult in MULTS:
        ideal = tq.requantize_int32(torch.from_numpy(acc),
                                    torch.tensor(mult, dtype=torch.float32))
        got = tq.requantize_int32_bitexact(torch.from_numpy(acc), mult)
        assert got.dtype == torch.int8
        assert int((ideal.int() - got.int()).abs().max()) <= 1, mult
        for a in (acc, extremes):
            got = tq.requantize_int32_bitexact(torch.from_numpy(a), mult)
            want = jq.requantize_int32_bitexact(jnp.asarray(a),
                                                jnp.float32(mult))
            assert np.array_equal(got.numpy(), np.asarray(want)), mult


@pytest.mark.parametrize("zero_point", [-5, 3])
def test_requant_bitexact_zero_point(rng, zero_point):
    acc = rng.integers(-2 ** 20, 2 ** 20, (256,)).astype(np.int32)
    got = tq.requantize_int32_bitexact(torch.from_numpy(acc), 0.0117,
                                       zero_point)
    want = jq.requantize_int32_bitexact(jnp.asarray(acc), jnp.float32(0.0117),
                                        zero_point)
    assert np.array_equal(got.numpy(), np.asarray(want))


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=-(2 ** 24), max_value=2 ** 24),
       st.floats(min_value=1e-6, max_value=0.9))
def test_requant_bitexact_property(acc, mult):
    a = torch.tensor([acc], dtype=torch.int32)
    ideal = tq.requantize_int32(a, torch.tensor(mult, dtype=torch.float32))
    got = tq.requantize_int32_bitexact(a, mult)
    want = jq.requantize_int32_bitexact(jnp.asarray([acc], jnp.int32),
                                        jnp.float32(mult))
    assert abs(int(ideal[0]) - int(got[0])) <= 1
    assert int(got[0]) == int(np.asarray(want)[0])


# ---------------------------------------------------------------------------
# QuantizedTensor and the LUT remainder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, 1])
def test_quantized_tensor_equal_reference(rng, axis):
    x = rng.normal(0, 1, (8, 8)).astype(np.float32)
    qt = tq.QuantizedTensor.from_float(torch.from_numpy(x), axis=axis)
    jqt = jq.QuantizedTensor.from_float(jnp.asarray(x), axis=axis)
    assert qt.shape == (8, 8) and qt.dtype == torch.int8
    assert np.array_equal(qt.q.numpy(), np.asarray(jqt.q))
    assert np.array_equal(qt.scale.numpy(), np.asarray(jqt.scale))
    assert np.array_equal(qt.dequantize().numpy(),
                          np.asarray(jqt.dequantize()))
    np.testing.assert_allclose(qt.dequantize().numpy(), x,
                               atol=float(qt.scale.max()) / 2 + 1e-7)


@pytest.mark.parametrize("scale_z", [8.0 / 127, 0.05])
def test_exp_lookup_onehot_equal_gather_and_reference(rng, scale_z):
    cfg = tlut.LUTConfig(scale_z=scale_z)
    table = tlut.build_exp_lut(cfg)
    z = rng.integers(-128, 128, (3, 5, 64)).astype(np.int8)
    z.reshape(-1)[:256] = np.arange(-128, 128)           # every entry once
    got = tlut.exp_lookup_onehot(torch.from_numpy(z), torch.from_numpy(table))
    want = jlut.exp_lookup_onehot(jnp.asarray(z), jnp.asarray(table))
    assert got.dtype == torch.int32
    assert torch.equal(got, tlut.exp_lookup(torch.from_numpy(z),
                                            torch.from_numpy(table)))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_recip_float_equal_reference(rng):
    """The same table entry and exponent as the reference's; the float
    ``exp2`` of an integer is exact in torch, while XLA's is a few ulps off
    (~1e-6 relative; the reference's ``exp2_int`` docstring says so), so
    the port equals the exact ``r * 2^e`` (``recip_factor``) bit for bit
    and JAX's within 2^-19."""
    cfg = tlut.LUTConfig(scale_z=8.0 / 127)
    table = tlut.build_recip_lut(cfg)
    s = np.concatenate([rng.uniform(1, 2 ** 20, 500),
                        2.0 ** np.arange(0, 24), [1.0, 1.5, 3.0]]
                       ).astype(np.float32)
    got = tlut.recip_float(torch.from_numpy(s), torch.from_numpy(table), cfg)
    want = jlut.recip_float(jnp.asarray(s), jnp.asarray(table),
                            jlut.LUTConfig(scale_z=8.0 / 127))
    r, e = jlut.recip_lookup(jnp.asarray(s), jnp.asarray(table),
                             jlut.LUTConfig(scale_z=8.0 / 127))
    exact = np.asarray(r).astype(np.float64) * 2.0 ** np.asarray(e)
    assert np.array_equal(got.numpy(), exact.astype(np.float32))
    assert torch.equal(got, tlut.recip_factor(torch.from_numpy(s),
                                              torch.from_numpy(table), cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2 ** -19,
                               atol=0)
    # within the table's resolution of the true reciprocal
    np.testing.assert_allclose(got.numpy(), 1.0 / s, rtol=2 ** -8)
