"""The kernels' two options in the PyTorch port against the JAX reference:
``lut_mode="compute"`` (the exp recomputed in f32 instead of read from the
f64-built table) and ``exact_recip`` (a division in place of the
reciprocal LUT).

* The compute table (``core.lut.build_exp_lut_compute``) against the
  reference's per-element formula on all 256 ``z_q``: within 1 LSB of
  ``e``, and the differing entries counted (XLA's and torch's f32 ``exp``
  may differ by an ulp, which can flip a rounding).
* Every plain entry of the port (prefill; fused and composed decode over
  the pool and over the dense cache; the paged and dense verify) with each
  option against ``repro.kernels.ops`` run as the JAX tests run it
  (``impl="interpret"``, the Pallas kernel bodies): within ``rtol = atol =
  2e-5``, the tolerance of ``tests/test_torch_kernels.py`` (f32 sums in
  another order), where the two exp tables are equal; and the reference's
  own bounds for what each option changes: compute against the table within
  5e-3 of the output's scale (``tests/test_kernels.py``), the reciprocal
  LUT against the division below 2^-8 of it
  (``tests/test_fused_decode.py``).
* The port's ``exact_recip`` path with ``exact=True`` bit for bit against
  an int64 numpy computation of the same sums and an IEEE f32 division: the
  function the kernels' ``kExactRecip`` instances compute
  (``tests/test_torch_cuda.py`` holds them against it on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro_torch.core import lut as tlut
from repro_torch.core import quantization as tq
from repro_torch.core.attention import AttentionSpec, luts_for
from repro_torch.core.lut import LUTConfig as TLUTConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import splitmax_attn, splitmax_decode

torch.set_num_threads(1)

SCALE_Z = 8.0 / 127
# a scale at which the f32 recompute and the f64 table differ (in 2 of 256
# entries, z_q 116 and 121), while the compute table equals the reference's
# formula: the compute cases run here
COMPUTE_SCALE_Z = 0.07170874612880124
TCFG = TLUTConfig(scale_z=SCALE_Z)
EXP = tlut.build_exp_lut(TCFG)
RECIP = tlut.build_recip_lut(TCFG)
SCALES = (np.float32(0.01), np.float32(0.012), np.float32(0.02))
TOL = dict(rtol=2e-5, atol=2e-5)
OPTIONS = {"compute": dict(lut_mode="compute"),
           "exact_recip": dict(exact_recip=True)}
B, HQ, HKV, D, BK = 2, 8, 2, 16, 8


def _luts(option):
    """(JAX config, port config, exp table, recip table, compute table) at
    the option's scale."""
    sz = COMPUTE_SCALE_Z if option == "compute" else SCALE_Z
    tcfg = TLUTConfig(scale_z=sz)
    return (jlut.LUTConfig(scale_z=sz), tcfg, tlut.build_exp_lut(tcfg),
            tlut.build_recip_lut(tcfg),
            tlut.build_exp_lut_compute(tcfg).numpy())


def _t(x):
    return torch.from_numpy(np.array(x))


def _reference_e(scale_z):
    """The reference kernels' ``lut_mode="compute"`` line on every z_q."""
    z_q = jnp.arange(-128, 128, dtype=jnp.int32)
    return np.asarray(jnp.round(jnp.exp((z_q - 127).astype(jnp.float32)
                                        * scale_z) * (1 << 15)))


# ------------------------------------------------------------ the table --

@pytest.mark.parametrize("scale_z", [8.0 / 127, 2.6 / 127, 0.05, 0.3,
                                     COMPUTE_SCALE_Z])
def test_compute_table_equals_the_reference_formula(scale_z):
    """At the configs' and the tests' scales the table is the reference's
    per-element values exactly (0 of 256 entries differ); the f64 table of
    the one-hot mode too, except at ``COMPUTE_SCALE_Z`` (1 LSB in 2)."""
    cfg = TLUTConfig(scale_z=scale_z)
    table = tlut.build_exp_lut_compute(cfg).numpy()
    assert table.dtype == np.int32 and table.max() <= 1 << cfg.exp_frac_bits
    np.testing.assert_array_equal(table, _reference_e(scale_z))
    diff = np.abs(table - tlut.build_exp_lut(cfg))
    assert diff.max() <= 1
    assert int((diff != 0).sum()) == (2 if scale_z == COMPUTE_SCALE_Z else 0)


def test_compute_table_within_one_lsb_over_a_sweep_of_scales():
    """Over 300 seeded scales in [0.001, 0.5) every entry is within 1 LSB
    of the reference's formula, and at most 0.1% of the 76,800 entries
    differ (3 here; the two f32 ``exp``s an ulp apart across a rounding
    edge)."""
    scales = np.random.default_rng(0).uniform(0.001, 0.5, 300)
    differ = 0
    for s in scales:
        table = tlut.build_exp_lut_compute(TLUTConfig(scale_z=float(s)))
        diff = np.abs(table.numpy() - _reference_e(float(s)))
        assert diff.max() <= 1, s
        differ += int((diff != 0).sum())
    assert differ <= 0.001 * 256 * len(scales), differ


def test_luts_for_serves_the_compute_table():
    _, cfg, _, recip, compute = _luts("compute")
    exp_lut, recip_lut = luts_for(cfg.scale_z, torch.device("cpu"), "compute")
    np.testing.assert_array_equal(exp_lut.numpy(), compute)
    np.testing.assert_array_equal(recip_lut.numpy(), recip)
    with pytest.raises(ValueError, match="lut_mode"):
        AttentionSpec(mode="int8", lut_mode="table")


# ------------------------------------------------ each plain entry vs JAX --

def _prefill(rng, option):
    q = rng.integers(-128, 128, (B, HQ, 64, D)).astype(np.int8)
    k = rng.integers(-128, 128, (B, HKV, 64, D)).astype(np.int8)
    v = rng.integers(-128, 128, (B, HKV, 64, D)).astype(np.int8)
    jcfg, tcfg, exp, recip, compute = _luts(option)
    kw = dict(causal=True, window=24)
    out = {}
    for opt in (None, option):
        out[("jax", opt)] = np.asarray(jops.splitmax_attention(
            q, k, v, *(jnp.float32(s) for s in SCALES), exp, recip, cfg=jcfg,
            block_q=32, block_k=32, impl="interpret", **kw,
            **OPTIONS.get(opt, {})))
        # the compute mode arrives at the port's ops as its table
        out[("port", opt)] = tops.splitmax_attention(
            _t(q), _t(k), _t(v), *(torch.tensor(s) for s in SCALES),
            _t(compute if opt == "compute" else exp), _t(recip), cfg=tcfg,
            exact_recip=opt == "exact_recip", **kw).numpy()
    return out


def _pool(rng, lens, mb):
    nb = 1 + B * mb
    kp = rng.integers(-128, 128, (nb, HKV, BK, D)).astype(np.int8)
    vp = rng.integers(-128, 128, (nb, HKV, BK, D)).astype(np.int8)
    table = rng.permutation(np.arange(1, nb))[:B * mb].reshape(B, mb)
    return kp, vp, table.astype(np.int32), np.asarray(lens, np.int32)


def _decode(rng, option, *, dense, fused, tokens=None):
    """One decode (or verify, ``tokens`` T) entry in both packages, without
    and with ``option``."""
    mb = 4
    kp, vp, table, lens = _pool(rng, [13, 29], mb)
    shape = (B, HQ, D) if tokens is None else (B, HQ, tokens, D)
    q = rng.normal(size=shape).astype(np.float32)
    axis = (1, 2) if tokens is None else (1, 3)
    s_q = jq.absmax_scale(jnp.asarray(q), axis=axis)
    t_sq = tq.absmax_scale(_t(q), axis=axis)
    if tokens is not None:
        s_q, t_sq = s_q[:, 0, :, 0], t_sq[:, 0, :, 0]
    cache = (kp, vp, table)
    if dense:                      # the slots' logical K/V as a dense cache
        cache = tuple(np.moveaxis(x[table], 2, 1).reshape(B, HKV, mb * BK, D)
                      for x in (kp, vp))
    name = "splitmax_decode" + ("_fused" if fused or tokens else "") + (
        "_verify" if tokens else "") + ("" if dense else "_paged")
    if not fused:
        q = np.asarray(jq.quantize(jnp.asarray(q), s_q))
    jcfg, tcfg, exp, recip, compute = _luts(option)
    extra = dict(block_k=BK) if dense else {}
    out = {}
    for opt in (None, option):
        out[("jax", opt)] = np.asarray(getattr(jops, name)(
            jnp.asarray(q), *(jnp.asarray(x) for x in cache), s_q,
            jnp.float32(SCALES[1]), jnp.float32(SCALES[2]), jnp.asarray(lens),
            exp, recip, cfg=jcfg, window=20, impl="interpret", **extra,
            **OPTIONS.get(opt, {})))
        out[("port", opt)] = getattr(tops, name)(
            _t(q), *(_t(x) for x in cache), t_sq, torch.tensor(SCALES[1]),
            torch.tensor(SCALES[2]), _t(lens),
            _t(compute if opt == "compute" else exp), _t(recip), cfg=tcfg,
            window=20, exact_recip=opt == "exact_recip").numpy()
    return out


ENTRIES = {
    "prefill": _prefill,
    "paged fused decode": lambda r, o: _decode(r, o, dense=False, fused=True),
    "paged composed decode": lambda r, o: _decode(r, o, dense=False,
                                                  fused=False),
    "dense fused decode": lambda r, o: _decode(r, o, dense=True, fused=True),
    "dense composed decode": lambda r, o: _decode(r, o, dense=True,
                                                  fused=False),
    "paged verify": lambda r, o: _decode(r, o, dense=False, fused=True,
                                         tokens=4),
    "dense verify": lambda r, o: _decode(r, o, dense=True, fused=True,
                                         tokens=4),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("option", list(OPTIONS))
def test_plain_entry_matches_interpret(rng, entry, option):
    out = ENTRIES[entry](rng, option)
    port, jax_ = out[("port", option)], out[("jax", option)]
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, jax_, **TOL)
    base = out[("port", None)]
    scale = float(np.abs(base).max()) + 1e-9
    if option == "compute":
        # tests/test_kernels.py::test_lut_compute_mode_within_one_lsb
        assert float(np.abs(port - base).max()) / scale < 5e-3
    else:
        # tests/test_fused_decode.py::test_fused_recip_lut_error_bounded
        err = float(np.abs(base - port).max()) / scale
        assert 0 < err < 2.0 ** -8, err


# ------------------------------------- exact_recip against an int64 oracle --

def _oracle(e, v, s_v):
    """acc and s summed in int64, each cast to f32 once, then f32(acc) *
    (1 / max(f32(s), 1)) * s_v, every step an IEEE f32 operation."""
    acc = (e @ v.astype(np.int64)).astype(np.float32)
    s = np.maximum(e.sum(-1, keepdims=True).astype(np.float32), np.float32(1))
    return acc * (np.float32(1) / s) * np.float32(s_v)


def _e(q, k, m_z, live):
    z32 = q.astype(np.int64) @ np.swapaxes(k.astype(np.int64), -1, -2)
    z = np.rint(z32.astype(np.float32) * np.asarray(m_z, np.float32))
    return np.where(live, EXP[np.clip(z, -128, 127).astype(np.int64) + 128]
                    .astype(np.int64), 0)


def test_exact_recip_prefill_equals_int64_oracle(rng):
    b, hq, hkv, s, d = 1, 8, 2, 100, 32
    q = rng.integers(-128, 128, (b, hq, s, d)).astype(np.int8)
    k = rng.integers(-128, 128, (b, hkv, s, d)).astype(np.int8)
    v = rng.integers(-128, 128, (b, hkv, s, d)).astype(np.int8)
    m_z = tops.requant_multiplier(torch.tensor(SCALES[0]),
                                  torch.tensor(SCALES[1]), d, TCFG)
    got = splitmax_attn.splitmax_attention_plain(
        _t(q), _t(k), _t(v), m_z.reshape(()), torch.tensor(SCALES[2]),
        _t(EXP), _t(RECIP), cfg=TCFG, causal=True, window=None,
        exact_recip=True, exact=True).numpy()
    live = np.arange(s)[None, :] <= np.arange(s)[:, None]
    e = _e(q.reshape(b, hkv, hq // hkv, s, d), k[:, :, None], m_z.numpy(),
           live)
    want = _oracle(e, v[:, :, None], SCALES[2]).reshape(b, hq, s, d)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tokens", [None, 4])
def test_exact_recip_decode_and_verify_equal_int64_oracle(rng, tokens):
    """The fused paged decode, and each verify row at its own length."""
    mb = 5
    kp, vp, table, lens = _pool(rng, [17, 40], mb)
    t = tokens or 1
    q = rng.normal(size=(B, HQ, t, D)).astype(np.float32)
    s_q = tq.absmax_scale(_t(q), axis=(1, 3))[:, 0, :, 0]        # (B, T)
    m_z = tops.requant_multiplier(s_q, torch.tensor(SCALES[1]), D, TCFG)
    args = (_t(kp), _t(vp), _t(table))
    tail = (torch.tensor(SCALES[2]), _t(lens), _t(EXP), _t(RECIP))
    if tokens is None:
        got = splitmax_decode.splitmax_decode_fused_paged_plain(
            _t(q[:, :, 0]), *args, m_z[:, 0].contiguous(),
            s_q[:, 0].contiguous(), *tail, cfg=TCFG, exact_recip=True,
            exact=True).numpy()[:, :, None]
    else:
        got = splitmax_decode.splitmax_decode_fused_verify_paged_plain(
            _t(q), *args, m_z, s_q, *tail, cfg=TCFG, exact_recip=True,
            exact=True).numpy()
    k_c = np.moveaxis(kp[table], 2, 1).reshape(B, HKV, mb * BK, D)
    v_c = np.moveaxis(vp[table], 2, 1).reshape(B, HKV, mb * BK, D)
    q_q = tq.quantize(_t(q), s_q[:, None, :, None]).numpy()
    for i in range(t):
        eff = lens - (t - 1 - i)
        live = np.arange(mb * BK)[None, :] < eff[:, None]
        qg = q_q[:, :, i].reshape(B, HKV, HQ // HKV, 1, D)
        e = _e(qg, k_c[:, :, None], m_z[:, i].numpy()[:, None, None, None,
                                                      None],
               live[:, None, None, None, :])
        want = _oracle(e, v_c[:, :, None], SCALES[2]).reshape(B, HQ, D)
        np.testing.assert_array_equal(got[:, :, i], want)
