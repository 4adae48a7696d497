"""Numerics core of the PyTorch port against ``repro.core``: LUT builds,
reads, the reciprocal bit path, absmax scales, quantize and the requant
multiplier must be bit-equal — integer outputs and f32 bit patterns alike."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import quantization as jq
from repro_torch.core import lut as tlut
from repro_torch.core import quantization as tq
from repro_torch.core.lut import LUTConfig as TLUTConfig
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

SCALES_Z = [8.0 / 127, 2.6 / 127, 0.05]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("scale_z", SCALES_Z)
@pytest.mark.parametrize("recip_bits", [6, 8])
def test_lut_builds_equal(scale_z, recip_bits):
    jc = jlut.LUTConfig(scale_z=scale_z, recip_index_bits=recip_bits)
    tc = TLUTConfig(scale_z=scale_z, recip_index_bits=recip_bits)
    np.testing.assert_array_equal(tlut.build_exp_lut(tc),
                                  jlut.build_exp_lut(jc))
    np.testing.assert_array_equal(tlut.build_recip_lut(tc),
                                  jlut.build_recip_lut(jc))
    assert tc.recip_table_size == jc.recip_table_size


def test_exp_lookup_equal():
    cfg = TLUTConfig(scale_z=8.0 / 127)
    table = tlut.build_exp_lut(cfg)
    z = np.arange(-128, 128, dtype=np.int8)
    got = tlut.exp_lookup(torch.from_numpy(z), torch.from_numpy(table))
    want = jlut.exp_lookup(jnp.asarray(z), jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _boundary_values():
    """Powers of two, recip-bin edges and one ulp either side of each, plus
    sub-1 values (clamped to 1) and large denominators."""
    base = []
    for e in range(0, 30):
        for i in (0, 1, 127, 128, 255):
            base.append((1.0 + i / 256.0) * 2.0 ** e)
    base = np.asarray(base + [0.0, 0.25, 0.999, 3.0, 12345.0, 9.2e6],
                      np.float32)
    return np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(0))])


@pytest.mark.parametrize("mbits", [6, 8])
def test_recip_mantissa_index_bit_equal(mbits):
    s = _boundary_values()
    ti, te = tlut.recip_mantissa_index(torch.from_numpy(s), mbits)
    ji, je = jlut.recip_mantissa_index(jnp.asarray(s), mbits)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_exp2_int_bit_equal():
    e = np.arange(-126, 128, dtype=np.int32)
    got = tlut.exp2_int(torch.from_numpy(e))
    want = jlut.exp2_int(jnp.asarray(e))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_recip_lookup_and_apply_bit_equal(rng):
    cfg_t, cfg_j = TLUTConfig(scale_z=0.05), jlut.LUTConfig(scale_z=0.05)
    table = tlut.build_recip_lut(cfg_t)
    s = _boundary_values()
    tr, te = tlut.recip_lookup(torch.from_numpy(s), torch.from_numpy(table),
                               cfg_t)
    jr, je = jlut.recip_lookup(jnp.asarray(s), jnp.asarray(table), cfg_j)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    x = rng.normal(size=s.shape).astype(np.float32) * 1e6
    got = tlut.recip_apply(torch.from_numpy(x), tr, te)
    want = jlut.recip_apply(jnp.asarray(x), jr, je)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("axis", [None, (1, 2), (1, 2, 3, 4)])
def test_absmax_scale_bit_equal(rng, axis):
    shape = (3, 4, 5, 6, 7) if axis == (1, 2, 3, 4) else (3, 4, 5)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    x[0] = 0.0                                   # eps floor on a zero slab
    got = tq.absmax_scale(torch.from_numpy(x), axis=axis)
    want = jq.absmax_scale(jnp.asarray(x), axis=axis)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_quantize_bit_equal_including_ties(rng):
    scale = np.float32(0.5)
    # exact .5 ties (round half to even), saturation and ordinary values
    ties = np.arange(-70, 70, dtype=np.float32) * 0.5 + 0.25
    x = np.concatenate([ties, rng.normal(size=500).astype(np.float32) * 40,
                        np.asarray([1e4, -1e4, 63.75, -64.25], np.float32)])
    for s in (scale, np.float32(0.0137)):
        got = tq.quantize(torch.from_numpy(x), torch.tensor(s))
        want = jq.quantize(jnp.asarray(x), jnp.float32(s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # per-slot scale broadcast, as the decode path calibrates it
    xs = rng.normal(size=(4, 8, 16)).astype(np.float32)
    s_t = tq.absmax_scale(torch.from_numpy(xs), axis=(1, 2))
    s_j = jq.absmax_scale(jnp.asarray(xs), axis=(1, 2))
    np.testing.assert_array_equal(tq.quantize(torch.from_numpy(xs), s_t).numpy(),
                                  np.asarray(jq.quantize(jnp.asarray(xs), s_j)))
    np.testing.assert_array_equal(
        _bits(tq.dequantize(tq.quantize(torch.from_numpy(xs), s_t), s_t)),
        _bits(jq.dequantize(jq.quantize(jnp.asarray(xs), s_j), s_j)))


def test_requantize_int32_bit_equal(rng):
    acc = rng.integers(-2 ** 21, 2 ** 21, size=4000).astype(np.int32)
    for m in (np.float32(1e-4), np.float32(3.3e-5), np.float32(0.0071)):
        got = tq.requantize_int32(torch.from_numpy(acc), torch.tensor(m))
        want = jq.requantize_int32(jnp.asarray(acc), jnp.float32(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", [16, 64, 80, 96, 128, 192])
def test_requant_multiplier_bit_equal(rng, d):
    """m_z = s_q*s_k/(sqrt(d)*s_z) in f32 in the reference's order
    (repro/kernels/ops.py:86-87, per-slot at :286-287)."""
    s_q = (rng.random(8).astype(np.float32) + 0.01) * 0.05
    s_k = np.float32(rng.random() * 0.03 + 1e-3)
    for scale_z in SCALES_Z:
        cfg = TLUTConfig(scale_z=scale_z)
        got = tops.requant_multiplier(torch.from_numpy(s_q),
                                      torch.tensor(s_k), d, cfg)
        want = (jnp.asarray(s_q) * jnp.float32(s_k)
                / (jnp.sqrt(jnp.float32(d)) * scale_z)).astype(jnp.float32)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
