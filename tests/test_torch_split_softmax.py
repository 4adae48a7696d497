"""The QAT numerics of the PyTorch port against the JAX reference: the
straight-through fake quant (``repro.core.quantization.fake_quant``), the
split softmax module (``repro.core.split_softmax``, mirroring
``tests/test_split_softmax.py``) and the blocked fakequant attention of
training (``repro.kernels.blocked.blocked_fakequant_attention``), forward
and ``dq/dk/dv``.  Inputs are drawn with numpy and passed to both packages.

Grid-snap flips: the two frameworks' f32 score products may differ in the
last bit, and where ``z / s_z`` sits on a rounding edge that last bit moves
``round(z / s_z)`` by one grid step (``s_z = 8/127``: ``e`` moves ~6.5%).
The blocked tests therefore compare the integer grid indices first and
allow a mismatch only where JAX's ``z / s_z`` lies within 1e-4 of a
half-integer; rows (and keys) touched by such a flip are left out of the
float comparison.  Float tolerance: rtol 1e-4 and atol 1e-5 of the largest
magnitude (exp and the f32 sums differ by ulps), 2e-2 of it where ``e`` and
``e . V`` run in bf16 (one bf16 rounding of a differently ordered sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.core import split_softmax as jss
from repro.core.lut import LUTConfig as JLUTConfig
from repro.kernels import blocked as jblocked
from repro_torch.core import quantization as tq
from repro_torch.core import split_softmax as ss
from repro_torch.core.lut import LUTConfig, Z_QUANT_MAX
from repro_torch.kernels import blocked as tblocked
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

CFG = LUTConfig(scale_z=8.0 / 127)
JCFG = JLUTConfig(scale_z=8.0 / 127)
EXP_LUT, RECIP_LUT = ss.make_luts(CFG)
S_Z = np.float32(8.0 / 127)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# ------------------------------------------------------------ fake quant --

def _fq_inputs(rng, s):
    """Normal values, exact ties on the grid, both clip edges and their
    f32 neighbours inside and outside."""
    s = np.float32(s)
    x = rng.normal(0, 60 * s, 512).astype(np.float32)
    ties = (np.arange(-20, 20, dtype=np.float32) + np.float32(0.5)) * s
    lo, hi = np.float32(-128) * s, np.float32(127) * s
    edges = np.array([lo, hi, np.nextafter(lo, np.float32(-1e9)),
                      np.nextafter(lo, np.float32(0)),
                      np.nextafter(hi, np.float32(1e9)),
                      np.nextafter(hi, np.float32(0)), 300 * s, -300 * s, 0],
                     np.float32)
    return np.concatenate([x, ties, edges])


@pytest.mark.parametrize("s", [0.02, 8.0 / 127, 0.37])
def test_fake_quant_forward_bit_equal(rng, s):
    x = _fq_inputs(rng, s)
    want = np.asarray(jq.fake_quant(jnp.asarray(x), jnp.float32(s)))
    got = tq.fake_quant(_t(x), torch.tensor(s, dtype=torch.float32))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("s", [0.02, 8.0 / 127])
def test_fake_quant_ste_gradient_equal_jax(rng, s):
    """The straight-through gradient, both clip edges included: g where
    -128 s <= x <= 127 s, 0 elsewhere, none to the scale."""
    x = _fq_inputs(rng, s)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jq.fake_quant(a, jnp.float32(s)) * w))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    scale = torch.tensor(s, dtype=torch.float32, requires_grad=True)
    (tq.fake_quant(xt, scale) * _t(w)).sum().backward()
    np.testing.assert_array_equal(_bits(xt.grad.numpy()), _bits(want))
    assert scale.grad is None
    inside = (x >= np.float32(-128) * np.float32(s)) & \
        (x <= np.float32(127) * np.float32(s))
    assert inside[-9:-3].tolist() == [True, True, False, True, False, True]


def test_fake_quant_forward_is_quant_grid(rng):
    x = rng.normal(0, 1, (128,)).astype(np.float32)
    y = tq.fake_quant(_t(x), torch.tensor(0.02)).numpy()
    grid = np.round(y / 0.02)
    assert np.allclose(grid, np.round(np.clip(x / 0.02, -128, 127)))


def test_fake_quant_ste_gradient():
    x = torch.tensor([0.5, -0.3, 100.0, -100.0], requires_grad=True)
    tq.fake_quant(x, torch.tensor(0.1)).sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 0.0, 0.0]


def test_fake_quant_calibrated_equal_jax(rng):
    x = rng.normal(0, 2, (4, 32)).astype(np.float32)
    for axis in (None, 1):
        want = np.asarray(jq.fake_quant_calibrated(jnp.asarray(x), axis=axis))
        got = tq.fake_quant_calibrated(_t(x), axis=axis).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


# ------------------------------------------------ split softmax (mirrors) --

def test_probs_close_to_float_softmax(rng):
    z = rng.normal(0, 3, (8, 64)).astype(np.float32)
    cfg = LUTConfig(scale_z=float(np.abs(z).max()) / 127)
    el, rl = ss.make_luts(cfg)
    p_ref = ss.safe_softmax(_t(z)).numpy()
    p_lut = ss.lut_split_softmax_probs(_t(z), cfg, el, rl).numpy()
    assert np.max(np.abs(p_ref - p_lut)) < 0.05
    np.testing.assert_allclose(p_lut.sum(-1), 1.0, atol=0.01)


def test_saturation_above_clip_flattens():
    z = np.zeros((1, 8), np.float32)
    z[0, 0], z[0, 1] = 12.0, 10.0
    p = ss.lut_split_softmax_probs(_t(z), CFG, EXP_LUT, RECIP_LUT).numpy()
    assert abs(p[0, 0] - p[0, 1]) < 1e-6


def test_exact_recip_ablation_tightens(rng):
    z = rng.normal(0, 2, (8, 64)).astype(np.float32)
    cfg = LUTConfig(scale_z=float(np.abs(z).max()) / 127)
    el, rl = ss.make_luts(cfg)
    p_ref = ss.safe_softmax(_t(z)).numpy()
    p_l = ss.lut_split_softmax_probs(_t(z), cfg, el, rl).numpy()
    p_e = ss.lut_split_softmax_probs(_t(z), cfg, el, rl,
                                     exact_recip=True).numpy()
    assert np.max(np.abs(p_e - p_l)) < 2.0 ** -8
    assert np.mean(np.abs(p_e - p_ref)) < 1e-3
    np.testing.assert_allclose(p_e.sum(-1), 1.0, atol=1e-5)


def test_zquantmax_shift_is_exact_in_float():
    z = torch.tensor([[1.0, 2.0, 3.0], [-5.0, 0.0, 5.0]])
    p1 = ss.safe_softmax(z)
    e = torch.exp(z - Z_QUANT_MAX * CFG.scale_z)
    p2 = e / e.sum(-1, keepdim=True)
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=2e-5)


def test_masked_lanes_never_contribute(rng):
    z = rng.normal(0, 2, (4, 32)).astype(np.float32)
    mask = np.ones((4, 32), bool)
    mask[:, 20:] = False
    p = ss.lut_split_softmax_probs(_t(z), CFG, EXP_LUT, RECIP_LUT,
                                   mask=_t(mask)).numpy()
    assert np.all(p[:, 20:] == 0.0)


def test_fakequant_matches_int8_probs(rng):
    z = rng.normal(0, 3, (4, 48)).astype(np.float32)
    p_fq = ss.fakequant_split_softmax(_t(z), CFG).numpy()
    p_int8 = ss.lut_split_softmax_probs(_t(z), CFG, EXP_LUT, RECIP_LUT,
                                        exact_recip=True).numpy()
    assert np.max(np.abs(p_fq - p_int8)) < 2e-3


def test_fakequant_gradient_nonzero(rng):
    z = _t(rng.normal(0, 2, (4, 16)).astype(np.float32)).requires_grad_(True)
    ss.fakequant_split_softmax(z, CFG)[..., 0].sum().backward()
    assert bool((z.grad != 0).any()) and bool(torch.isfinite(z.grad).all())


@pytest.mark.parametrize("n,sigma", [(2, 0.5), (7, 6.0), (33, 2.0),
                                     (64, 4.0)])
def test_probs_are_distribution(n, sigma):
    z = np.random.default_rng(n).normal(0, sigma, (3, n)).astype(np.float32)
    p = ss.lut_split_softmax_probs(_t(z), CFG, EXP_LUT, RECIP_LUT).numpy()
    assert np.all(p >= 0) and np.all(p.sum(-1) < 1.02)
    live = p.sum(-1) > 0
    assert np.all(np.abs(p.sum(-1)[live] - 1.0) < 0.02)


def test_split_attention_epilogue(rng):
    z = rng.normal(0, 3, (2, 16, 16)).astype(np.float32)
    cfg = LUTConfig(scale_z=float(np.abs(z).max()) / 127)
    el, rl = ss.make_luts(cfg)
    v_q = rng.integers(-128, 128, (2, 16, 8)).astype(np.int8)
    out, out_q = ss.split_softmax_attention(
        _t(z), _t(v_q), torch.tensor(0.02), cfg, el, rl,
        out_scale=torch.tensor(0.05))
    want = ss.safe_softmax(_t(z)).numpy() @ (v_q.astype(np.float32) * 0.02)
    np.testing.assert_allclose(out.numpy(), want, atol=0.3)
    assert out_q.dtype == torch.int8


# ------------------------------------------------- split softmax vs JAX --

def test_lut_probs_and_epilogue_bit_equal_jax(rng):
    """The integer LUT path: probabilities and the attention epilogue are
    the reference's bits (the f32 sums of integer e are exact)."""
    z = rng.normal(0, 3, (2, 16, 40)).astype(np.float32)
    mask = rng.random((2, 16, 40)) > 0.2
    jel, jrl = jss.make_luts(JCFG)
    for exact in (False, True):
        want = jss.lut_split_softmax_probs(jnp.asarray(z), JCFG, jel, jrl,
                                           mask=jnp.asarray(mask),
                                           exact_recip=exact)
        got = ss.lut_split_softmax_probs(_t(z), CFG, EXP_LUT, RECIP_LUT,
                                         mask=_t(mask), exact_recip=exact)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    v_q = rng.integers(-128, 128, (2, 40, 8)).astype(np.int8)
    jo, jo_q = jss.split_softmax_attention(
        jnp.asarray(z), jnp.asarray(v_q), jnp.float32(0.02), JCFG, jel, jrl,
        mask=jnp.asarray(mask), out_scale=jnp.float32(0.05))
    to, to_q = ss.split_softmax_attention(
        _t(z), _t(v_q), torch.tensor(0.02), CFG, EXP_LUT, RECIP_LUT,
        mask=_t(mask), out_scale=torch.tensor(0.05))
    np.testing.assert_array_equal(_bits(to.numpy()), _bits(jo))
    np.testing.assert_array_equal(to_q.numpy(), np.asarray(jo_q))


def test_safe_softmax_equal_jax(rng):
    z = rng.normal(0, 3, (4, 24)).astype(np.float32)
    mask = rng.random((4, 24)) > 0.3
    mask[1] = False                                  # a fully masked row
    want = np.asarray(jss.safe_softmax(jnp.asarray(z), jnp.asarray(mask)))
    got = ss.safe_softmax(_t(z), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[1] == 0)


def test_fakequant_split_softmax_and_grad_equal_jax(rng):
    """Forward and the STE gradient against ``jax.grad``; the grid indices
    are equal (same input, same division), so only exp's last bit
    differs."""
    z = rng.normal(0, 3, (6, 48)).astype(np.float32)
    z[0, :8] = -12.0                          # below the LUT floor
    mask = rng.random((6, 48)) > 0.25
    w = rng.normal(0, 1, z.shape).astype(np.float32)
    jf = lambda a: jnp.sum(jss.fakequant_split_softmax(  # noqa: E731
        a, JCFG, mask=jnp.asarray(mask)) * w)
    want_p = np.asarray(jss.fakequant_split_softmax(
        jnp.asarray(z), JCFG, mask=jnp.asarray(mask)))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(z)))
    zt = _t(z).requires_grad_(True)
    p = ss.fakequant_split_softmax(zt, CFG, mask=_t(mask))
    (p * _t(w)).sum().backward()
    np.testing.assert_allclose(p.detach().numpy(), want_p, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(zt.grad.numpy(), want_g, rtol=1e-4,
                               atol=1e-6 * np.abs(want_g).max())
    assert np.all(p.detach().numpy()[0, :8] == 0)


# --------------------------------------------------- blocked attention --

B, HQ, HKV, S, D, BK = 2, 4, 2, 64, 16, 16


def _qkv(seed, *, s=S):
    r = np.random.default_rng(seed)
    q = (r.normal(0, 1, (B, HQ, s, D)) * 1.7).astype(np.float32)
    k = (r.normal(0, 1, (B, HKV, s, D)) * 1.7).astype(np.float32)
    v = r.normal(0, 1, (B, HKV, s, D)).astype(np.float32)
    w = r.normal(0, 1, (B, HQ, s, D)).astype(np.float32)
    return q, k, v, w


def _grid_flips(q, k):
    """Positions (b, hq, i, j) where the packages' grid indices differ;
    each must sit within 1e-4 of a half-integer of JAX's z / s_z."""
    g = HQ // HKV
    zj = np.asarray(jnp.einsum(
        "bkgqd,bkcd->bkgqc", jnp.asarray(q).reshape(B, HKV, g, -1, D),
        jnp.asarray(k)) * (jnp.float32(1) / jnp.sqrt(jnp.float32(D))))
    zt = torch.einsum("bkgqd,bkcd->bkgqc", _t(q).reshape(B, HKV, g, -1, D),
                      _t(k)).numpy() * np.float32(1 / np.sqrt(D))
    rj = np.clip(np.round(zj / S_Z), -128, 127)
    rt = np.clip(np.round(zt / S_Z), -128, 127)
    flips = rj != rt
    frac = np.abs(np.abs(zj / S_Z - np.floor(zj / S_Z)) - 0.5)
    assert np.all(frac[flips] < 1e-4), frac[flips]
    return flips.reshape(B, HQ, zj.shape[3], zj.shape[4])


def _jax_run(q, k, v, w, **kw):
    def f(q, k, v):
        out = jblocked.blocked_fakequant_attention(q, k, v, JCFG, **kw)
        return jnp.sum(out * w), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_run(q, k, v, w, fn=tblocked.blocked_fakequant_attention, **kw):
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = fn(qt, kt, vt, CFG, **kw)
    (out * _t(w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


def _close(got, want, keep, tol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got[keep], want[keep], rtol=tol,
                               atol=tol * 0.1 * scale)


VARIANTS = {
    "causal": dict(),
    "window": dict(window=24),
    "kv_valid": dict(causal=False, kv_valid_len=40),
    "triangular": dict(triangular=True),
    "bf16": dict(score_dtype="bfloat16"),
    "no_remat": dict(remat=False),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_blocked_fakequant_forward_and_grads_equal_jax(name):
    kw = dict(VARIANTS[name], block_k=BK)
    q, k, v, w = _qkv(3 + sorted(VARIANTS).index(name))
    jkw = dict(kw)
    tkw = dict(kw)
    if "score_dtype" in kw:
        jkw["score_dtype"] = jnp.bfloat16
        tkw["score_dtype"] = torch.bfloat16
    j_out, j_g = _jax_run(q, k, v, w, **jkw)
    t_out, t_g = _torch_run(q, k, v, w, **tkw)
    flips = _grid_flips(q, k)
    g = HQ // HKV
    rows = ~flips.any(-1)                                   # (B, HQ, S)
    keys = ~flips.reshape(B, HKV, g, S, S).any((2, 3))      # (B, HKV, S)
    tol = 2e-2 if "score_dtype" in kw else 1e-4
    assert np.isfinite(t_out).all() and rows.mean() > 0.95
    _close(t_out, j_out, rows, tol)
    _close(t_g[0], j_g[0], rows, tol)
    _close(t_g[1], j_g[1], keys, tol)
    _close(t_g[2], j_g[2], keys, tol)


@pytest.mark.parametrize("name", ["causal", "window", "kv_valid"])
def test_blocked_fakequant_equals_unblocked_oracle(name):
    """The blocked scan against the port's own einsum oracle,
    ``fakequant_split_softmax`` over the whole score matrix."""
    kw = VARIANTS[name]
    q, k, v, w = _qkv(11)
    causal = kw.get("causal", True)

    def oracle(qt, kt, vt, cfg, **_):
        kf = tref._expand_gqa(kt, HQ)
        vf = tref._expand_gqa(vt, HQ)
        z = torch.einsum("bhqd,bhkd->bhqk", qt, kf) * np.float32(
            1 / np.sqrt(D))
        mask = tblocked._chunk_mask(S, S, 0, causal=causal,
                                    window=kw.get("window"),
                                    kv_valid_len=kw.get("kv_valid_len"))
        return ss.fakequant_split_softmax(z, cfg, mask=mask) @ vf

    o_out, o_g = _torch_run(q, k, v, w, fn=oracle)
    t_out, t_g = _torch_run(q, k, v, w, block_k=BK, **kw)
    np.testing.assert_allclose(t_out, o_out, rtol=1e-4,
                               atol=1e-5 * np.abs(o_out).max())
    for got, want in zip(t_g, o_g):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_blocked_block_k_must_divide():
    q, k, v, _ = _qkv(0, s=48)
    with pytest.raises(ValueError, match="does not divide"):
        tblocked.blocked_fakequant_attention(_t(q), _t(k), _t(v), CFG,
                                             block_k=20)


def test_float_attention_equal_jax(rng):
    from repro.kernels import ref as jref
    q, k, v, _ = _qkv(5)
    for kw in (dict(), dict(window=9), dict(causal=False)):
        want = np.asarray(jref.safe_softmax_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
        got = tref.safe_softmax_attention_ref(_t(q), _t(k), _t(v),
                                              **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
