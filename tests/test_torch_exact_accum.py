"""The exact accumulation contract of the port's split-softmax kernels.

The CUDA kernels sum ``e * v`` and ``e`` exactly in integers and convert
each sum to f32 once (``src/repro_torch/kernels/csrc/splitmax_common.cuh``).
On the CPU the plain versions' ``exact=True`` mode computes that function;
here it is held

  * bit for bit against an int64 numpy computation of the same sums;
  * within ``rtol = atol = 2e-5`` (at ``s_v = 0.02``) of the default plain
    versions and of the JAX reference's ``xla`` path, the tolerance of
    ``tests/test_torch_kernels.py``: the f32 sums round, the exact ones do
    not, and that is the whole difference;

and the integer ranges the kernels rely on are checked in numpy int32.  The
card holds every kernel against ``exact=True`` with ``torch.equal``
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro_torch.core import lut as tlut
from repro_torch.core import paged_kv as tpaged
from repro_torch.core import quantization as tq
from repro_torch.core.lut import LUTConfig as TLUTConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import splitmax_attn, splitmax_decode

torch.set_num_threads(1)

SCALE_Z = 8.0 / 127
JCFG = jlut.LUTConfig(scale_z=SCALE_Z)
TCFG = TLUTConfig(scale_z=SCALE_Z)
EXP = tlut.build_exp_lut(TCFG)
RECIP = tlut.build_recip_lut(TCFG)
SCALES = (np.float32(0.01), np.float32(0.012), np.float32(0.02))
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------ the int64 oracle --

def _recip_np(s32):
    """RecipLUT(s) for f32 s >= 1 from its bit pattern, as lut.recip_lookup."""
    bits = s32.view(np.int32)
    expo = ((bits >> 23) & 0xFF) - 127
    idx = (bits >> (23 - TCFG.recip_index_bits)) & ((1 << TCFG.recip_index_bits) - 1)
    p2 = ((-expo - TCFG.recip_frac_bits + 127) << 23).astype(np.int32)
    return RECIP[idx].astype(np.float32) * p2.view(np.float32)


def _e_np(q, k, m_z, live):
    """e (int64) for int8 ``q (..., Sq, D)`` against ``k (..., Sk, D)``,
    ``m_z`` broadcasting against the scores, 0 where ``live`` is False."""
    z32 = q.astype(np.int64) @ np.swapaxes(k.astype(np.int64), -1, -2)
    z = np.rint(z32.astype(np.float32) * np.asarray(m_z, np.float32))
    z_q = np.clip(z, -128, 127).astype(np.int64)
    return np.where(live, EXP[z_q + 128].astype(np.int64), 0)


def _finalize_np(e, v, s_v):
    """acc = sum e * v and s = sum e in int64, each cast to f32 once, then
    f32(acc) * RecipLUT(max(f32(s), 1)) * s_v."""
    acc = (e @ v.astype(np.int64)).astype(np.float32)
    s = np.maximum(e.sum(-1, keepdims=True).astype(np.float32), np.float32(1))
    return acc * _recip_np(s) * np.float32(s_v)


def _prefill_oracle(q, k, v, m_z, *, causal, window, kv_valid):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, d)
    rows, cols = np.arange(sq)[:, None], np.arange(sk)[None, :]
    live = cols < kv_valid
    if causal:
        live = live & (cols <= rows)
    if window is not None:
        live = live & (cols > rows - window)
    e = _e_np(qg, k[:, :, None], m_z, live)
    return _finalize_np(e, v[:, :, None], SCALES[2]).reshape(b, hq, sq, d)


def _decode_oracle(q_q, k_c, v_c, m_z, live):
    """int8 q_q (B, Hq, D) vs a contiguous cache (B, Hkv, S, D) at the
    ``live (B, S)`` positions; m_z (B,)."""
    b, hq, d = q_q.shape
    hkv = k_c.shape[1]
    qg = q_q.reshape(b, hkv, hq // hkv, 1, d)
    e = _e_np(qg, k_c[:, :, None], np.asarray(m_z)[:, None, None, None, None],
              live[:, None, None, None, :])
    return _finalize_np(e, v_c[:, :, None], SCALES[2]).reshape(b, hq, d)


def _live_np(lens, s, window):
    pos = np.arange(s)[None, :]
    lens = np.asarray(lens)[:, None]
    live = pos < lens
    if window is not None:
        live = live & (pos > lens - 1 - window)
    return live


def _qkv(rng, b, hq, hkv, sq, sk, d):
    return (rng.integers(-128, 128, (b, hq, sq, d)).astype(np.int8),
            rng.integers(-128, 128, (b, hkv, sk, d)).astype(np.int8),
            rng.integers(-128, 128, (b, hkv, sk, d)).astype(np.int8))


def _m_z(s_q, d):
    return np.float32(s_q) * SCALES[1] / (np.float32(np.sqrt(d))
                                          * np.float32(SCALE_Z))


# --------------------------------------------------------------- prefill --

PREFILL_SHAPES = [
    # b, hq, hkv, sq, sk, d
    (2, 8, 2, 100, 100, 16),      # the smoke model's heads
    (1, 32, 4, 250, 250, 64),     # TinyLlama-1.1B's heads, the serving prompt
    (1, 4, 1, 50, 100, 32),       # MQA, rectangular
]
MODES = {"causal": dict(causal=True, window=None, kv_valid=None),
         "window": dict(causal=True, window=48, kv_valid=None),
         "kv_valid": dict(causal=False, window=None, kv_valid=70)}


def _prefill_torch(q, k, v, mode, exact):
    kw = MODES[mode]
    return splitmax_attn.splitmax_attention_plain(
        _t(q), _t(k), _t(v),
        tops.requant_multiplier(torch.tensor(SCALES[0]),
                                torch.tensor(SCALES[1]), q.shape[-1],
                                TCFG).reshape(()),
        torch.tensor(SCALES[2]), _t(EXP), _t(RECIP), cfg=TCFG,
        causal=kw["causal"], window=kw["window"],
        kv_valid_len=kw["kv_valid"], exact=exact).numpy()


@pytest.mark.parametrize("shape", PREFILL_SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_exact_equals_int64_oracle(rng, shape, mode):
    b, hq, hkv, sq, sk, d = shape
    q, k, v = _qkv(rng, b, hq, hkv, sq, sk, d)
    kw = MODES[mode]
    want = _prefill_oracle(q, k, v, _m_z(SCALES[0], d), causal=kw["causal"],
                           window=kw["window"],
                           kv_valid=sk if kw["kv_valid"] is None
                           else kw["kv_valid"])
    np.testing.assert_array_equal(_prefill_torch(q, k, v, mode, True), want)


@pytest.mark.parametrize("shape", PREFILL_SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_exact_within_tolerance_of_default_and_xla(rng, shape, mode):
    b, hq, hkv, sq, sk, d = shape
    q, k, v = _qkv(rng, b, hq, hkv, sq, sk, d)
    kw = MODES[mode]
    exact = _prefill_torch(q, k, v, mode, True)
    np.testing.assert_allclose(exact, _prefill_torch(q, k, v, mode, False),
                               **TOL)
    jkw = dict(causal=kw["causal"], window=kw["window"])
    if kw["kv_valid"] is not None:
        jkw["kv_valid_len"] = jnp.int32(kw["kv_valid"])
    want = jops.splitmax_attention(q, k, v, *(jnp.float32(s) for s in SCALES),
                                   EXP, RECIP, cfg=JCFG, impl="xla",
                                   block_q=128, block_k=128, **jkw)
    np.testing.assert_allclose(exact, np.asarray(want), **TOL)


# ---------------------------------------------------------------- decode --

DECODE_SHAPES = [
    # b, hq, hkv, d, bk, mb
    (3, 8, 2, 16, 8, 4),          # the smoke model's heads
    (4, 32, 4, 64, 32, 10),       # TinyLlama-1.1B's heads, churn lengths
]


def _decode_case(rng, b, hq, hkv, d, bk, mb):
    """A shuffled pool with slots of ragged lengths (one on a block
    boundary, one idle), f32 queries and per-slot scales."""
    nb = 1 + b * mb
    kp = rng.integers(-128, 128, (nb, hkv, bk, d)).astype(np.int8)
    vp = rng.integers(-128, 128, (nb, hkv, bk, d)).astype(np.int8)
    lens = [1 + (i * 97) % (mb * bk) for i in range(b)]
    lens[0] = bk
    lens[-1] = 0
    table = np.zeros((b, mb), np.int32)
    ids = rng.permutation(np.arange(1, nb))
    for i, n in enumerate(lens):
        live = tpaged.blocks_per_seq(n, bk) if n else 0
        table[i, :live] = ids[i * mb:i * mb + live]
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    return q, kp, vp, table, np.asarray(lens, np.int32)


def _paged_args(q, kp, vp, table, lens):
    s_q = tq.absmax_scale(_t(q), axis=(1, 2)).reshape(-1)
    d = q.shape[-1]
    m_z = tops.requant_multiplier(s_q, torch.tensor(SCALES[1]), d, TCFG)
    return [_t(q), _t(kp), _t(vp), _t(table), m_z, s_q,
            torch.tensor(SCALES[2]), _t(lens), _t(EXP), _t(RECIP)]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_decode_exact_equals_int64_oracle(rng, shape, window, layout):
    q, kp, vp, table, lens = _decode_case(rng, *shape)
    args = _paged_args(q, kp, vp, table, lens)
    q_q = np.clip(np.rint(q / args[5].numpy()[:, None, None]), -128,
                  127).astype(np.int8)
    k_c = np.swapaxes(kp[table], 1, 2).reshape(q.shape[0], kp.shape[1], -1,
                                               q.shape[-1])
    v_c = np.swapaxes(vp[table], 1, 2).reshape(k_c.shape)
    live = _live_np(lens, k_c.shape[2], window) & np.repeat(
        table != tpaged.TRASH_BLOCK, kp.shape[2], axis=1)
    want = _decode_oracle(q_q, k_c, v_c, args[4].numpy(), live)
    if layout == "paged":
        got = splitmax_decode.splitmax_decode_fused_paged_plain(
            *args, cfg=TCFG, window=window, exact=True)
    else:
        got = splitmax_decode.splitmax_decode_fused_plain(
            args[0], _t(k_c), _t(v_c), *args[4:], cfg=TCFG, window=window,
            exact=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[-1].any()                        # the idle slot


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("window", [None, 20])
def test_decode_exact_within_tolerance_of_default_and_xla(rng, shape,
                                                          window):
    q, kp, vp, table, lens = _decode_case(rng, *shape)
    args = _paged_args(q, kp, vp, table, lens)
    exact = splitmax_decode.splitmax_decode_fused_paged_plain(
        *args, cfg=TCFG, window=window, exact=True).numpy()
    default = splitmax_decode.splitmax_decode_fused_paged_plain(
        *args, cfg=TCFG, window=window).numpy()
    np.testing.assert_allclose(exact, default, **TOL)
    want = jops.splitmax_decode_fused_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jq.absmax_scale(jnp.asarray(q), axis=(1, 2)), jnp.float32(SCALES[1]),
        jnp.float32(SCALES[2]), jnp.asarray(lens), EXP, RECIP, cfg=JCFG,
        window=window, impl="xla")
    # the reference reads the idle slot's trash block; the port returns 0
    np.testing.assert_allclose(exact[:-1], np.asarray(want)[:-1], **TOL)


@pytest.mark.parametrize("gamma", [2, 4])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_verify_exact_rows_equal_the_exact_decode(rng, gamma, layout):
    """Every exact verify row is the exact decode at its effective length,
    and within tolerance of JAX's verify (``xla``)."""
    b, hq, hkv, d, bk, mb = 3, 8, 2, 16, 8, 5
    kp = rng.integers(-128, 128, (1 + b * mb, hkv, bk, d)).astype(np.int8)
    vp = rng.integers(-128, 128, (1 + b * mb, hkv, bk, d)).astype(np.int8)
    lens = np.asarray([gamma, 2 * bk + 1, 33], np.int32)
    table = rng.permutation(np.arange(1, 1 + b * mb)).reshape(b, mb).astype(
        np.int32)
    q = rng.normal(size=(b, hq, gamma, d)).astype(np.float32)
    s_q = tq.absmax_scale(_t(q), axis=(1, 3))[:, 0, :, 0].contiguous().numpy()
    m_z = tops.requant_multiplier(_t(s_q), torch.tensor(SCALES[1]), d, TCFG)
    tail = (torch.tensor(SCALES[2]), _t(lens), _t(EXP), _t(RECIP))
    if layout == "paged":
        cache = (_t(kp), _t(vp), _t(table))
        verify = splitmax_decode.splitmax_decode_fused_verify_paged_plain
        decode = splitmax_decode.splitmax_decode_fused_paged_plain
        jverify = jops.splitmax_decode_fused_verify_paged
        jcache = (jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table))
    else:
        k_c = np.swapaxes(kp[table], 1, 2).reshape(b, hkv, -1, d)
        v_c = np.swapaxes(vp[table], 1, 2).reshape(k_c.shape)
        cache = (_t(k_c), _t(v_c))
        verify = splitmax_decode.splitmax_decode_fused_verify_plain
        decode = splitmax_decode.splitmax_decode_fused_plain
        jverify = jops.splitmax_decode_fused_verify
        jcache = (jnp.asarray(k_c), jnp.asarray(v_c))
    got = verify(_t(q), *cache, m_z, _t(s_q), *tail, cfg=TCFG, exact=True)
    for t in range(gamma):
        row = decode(_t(q[:, :, t]), *cache, m_z[:, t].contiguous(),
                     _t(s_q[:, t]), tail[0], _t(lens - (gamma - 1 - t)),
                     *tail[2:], cfg=TCFG, exact=True)
        assert torch.equal(got[:, :, t], row), t
    want = jverify(jnp.asarray(q), *jcache, jnp.asarray(s_q),
                   jnp.float32(SCALES[1]), jnp.float32(SCALES[2]),
                   jnp.asarray(lens), EXP, RECIP, cfg=JCFG, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _verify_oracle(q, s_q, m_z, k_c, v_c, lens, live_extra, window):
    """Token t of every slot as the int64 decode oracle at ``lens - (T-1-t)``
    with its own s_q[:, t] and m_z[:, t]; ``live_extra (B, S)`` masks
    positions that hold no data (the paged pool's trash block)."""
    gamma = q.shape[2]
    outs = []
    for t in range(gamma):
        q_q = np.clip(np.rint(q[:, :, t] / s_q[:, t, None, None]), -128,
                      127).astype(np.int8)
        live = _live_np(lens - (gamma - 1 - t), k_c.shape[2],
                        window) & live_extra
        outs.append(_decode_oracle(q_q, k_c, v_c, m_z[:, t], live))
    return np.stack(outs, axis=2)


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("gamma,d", [(16, 64), (8, 128)])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_verify_exact_equals_int64_oracle_at_a_full_group(rng, gamma, d,
                                                          window, layout):
    """Group 8 x T x D past the first verify kernel's cap of 4096 outputs:
    the exact plain versions, which the card holds the kernels to, equal
    the int64 oracle bit for bit (an idle slot included)."""
    b, hq, hkv, bk, mb = 3, 8, 1, 32, 5
    kp = rng.integers(-128, 128, (1 + b * mb, hkv, bk, d)).astype(np.int8)
    vp = rng.integers(-128, 128, (1 + b * mb, hkv, bk, d)).astype(np.int8)
    lens = np.asarray([gamma + 1, mb * bk, 0], np.int32)
    table = rng.permutation(np.arange(1, 1 + b * mb)).reshape(b, mb).astype(
        np.int32)
    table[2] = tpaged.TRASH_BLOCK
    q = rng.normal(size=(b, hq, gamma, d)).astype(np.float32)
    s_q = tq.absmax_scale(_t(q), axis=(1, 3))[:, 0, :, 0].contiguous()
    m_z = tops.requant_multiplier(s_q, torch.tensor(SCALES[1]), d, TCFG)
    k_c = np.swapaxes(kp[table], 1, 2).reshape(b, hkv, -1, d)
    v_c = np.swapaxes(vp[table], 1, 2).reshape(k_c.shape)
    tail = (torch.tensor(SCALES[2]), _t(lens), _t(EXP), _t(RECIP))
    if layout == "paged":
        got = splitmax_decode.splitmax_decode_fused_verify_paged_plain(
            _t(q), _t(kp), _t(vp), _t(table), m_z, s_q, *tail, cfg=TCFG,
            window=window, exact=True)
    else:
        got = splitmax_decode.splitmax_decode_fused_verify_plain(
            _t(q), _t(k_c), _t(v_c), m_z, s_q, *tail, cfg=TCFG,
            window=window, exact=True)
    live_extra = np.repeat(table != tpaged.TRASH_BLOCK, bk, axis=1)
    want = _verify_oracle(q, s_q.numpy(), m_z.numpy(), k_c, v_c, lens,
                          live_extra, window)
    assert got.shape == (b, hq, gamma, d)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2].any()                         # the idle slot


@pytest.mark.parametrize("window", [None, 20])
def test_exact_bits_do_not_depend_on_the_tiling(rng, window):
    """The same K/V dense and in pools of block_k 8 and 32: the exact plain
    versions give equal bits, as the split-K kernels must."""
    b, hq, hkv, d, s = 4, 32, 4, 64, 96
    k = rng.integers(-128, 128, (b, hkv, s, d)).astype(np.int8)
    v = rng.integers(-128, 128, (b, hkv, s, d)).astype(np.int8)
    lens = np.asarray([1, 32, 77, 96], np.int32)
    q = _t(rng.normal(size=(b, hq, d)).astype(np.float32))
    s_q = tq.absmax_scale(q, axis=(1, 2)).reshape(-1)
    m_z = tops.requant_multiplier(s_q, torch.tensor(SCALES[1]), d, TCFG)
    tail = (torch.tensor(SCALES[2]), _t(lens), _t(EXP), _t(RECIP))
    dense = splitmax_decode.splitmax_decode_fused_plain(
        q, _t(k), _t(v), m_z, s_q, *tail, cfg=TCFG, window=window,
        exact=True)
    for bk in (8, 32):
        mb = s // bk
        table = (1 + np.arange(b * mb)).reshape(b, mb).astype(np.int32)
        pools = [np.zeros((1 + b * mb, hkv, bk, d), np.int8) for _ in range(2)]
        for src, pool in zip((k, v), pools):
            pool[1:] = src.reshape(b, hkv, mb, bk, d).transpose(
                0, 2, 1, 3, 4).reshape(-1, hkv, bk, d)
        paged = splitmax_decode.splitmax_decode_fused_paged_plain(
            q, _t(pools[0]), _t(pools[1]), _t(table), m_z, s_q, *tail,
            cfg=TCFG, window=window, exact=True)
        assert torch.equal(dense, paged), bk


# ------------------------------------------------------------ the ranges --

def test_adversarial_f32_sums_round_where_exact_sums_do_not():
    """4096 keys, every other one at e = 2^15 with v = -128 and the rest at
    the odd e = ExpLUT[128] with v = 1: past 2^24 the f32 running sum drops
    the small terms, the exact sum keeps them."""
    s, d = 4096, 64
    assert EXP[255] == 1 << 15 and EXP[128] % 2 == 1
    q_q = np.full((1, 1, d), 127, np.int8)
    k = np.zeros((1, 1, s, d), np.int8)
    k[:, :, 0::2] = 127                          # z32 = 64 * 127^2: z_q 127
    v = np.ones((1, 1, s, d), np.int8)
    v[:, :, 0::2] = -128
    m_z = torch.ones(1)
    lens = np.asarray([s], np.int32)
    args = (_t(q_q), _t(k), _t(v), m_z, torch.tensor(SCALES[2]), _t(lens),
            _t(EXP), _t(RECIP))
    exact = splitmax_decode.splitmax_decode_plain(*args, cfg=TCFG,
                                                  exact=True)
    default = splitmax_decode.splitmax_decode_plain(*args, cfg=TCFG)
    e = np.where(np.arange(s) % 2 == 0, 1 << 15, int(EXP[128]))
    acc = int((e * v[0, 0, :, 0].astype(np.int64)).sum())
    assert acc == -(s // 2) * (1 << 22) + (s // 2) * int(EXP[128])
    f32_acc = (torch.from_numpy(e.astype(np.float32))[None]
               @ torch.from_numpy(v[0, 0].astype(np.float32)))[0, 0]
    assert float(f32_acc) != float(np.float32(acc))   # the f32 sum rounded
    want = _decode_oracle(q_q, k, v, np.ones(1, np.float32),
                          _live_np(lens, s, None))
    np.testing.assert_array_equal(exact.numpy(), want)
    assert not torch.equal(exact, default)
    np.testing.assert_allclose(exact.numpy(), default.numpy(), **TOL)


def test_byte_split_int32_sums_are_exact_at_65535_keys(rng):
    """The prefill's scheme in numpy int32, as the tensor cores add: at
    65535 keys of the largest |e_lo * v| and |e_hi * v| no int32 sum
    overflows, s stays below 2^31, and 256 * hi + lo is sum e * v; one key
    more would overflow s.  The decode's int32 chunks of kIntChunk keys
    have the same margin."""
    n = splitmax_attn.MAX_EXACT_KEYS
    assert n == 65535
    for e_val, v_val in ((1 << 15, -128), (255, -128), (255 + 256 * 127, 127)):
        e = np.full(n, e_val, np.int64)
        v = np.full(n, v_val, np.int64)
        lo = np.sum(((e & 255) * v).astype(np.int32), dtype=np.int32)
        hi = np.sum(((e >> 8) * v).astype(np.int32), dtype=np.int32)
        assert int(lo) == int(((e & 255) * v).sum())
        assert int(hi) == int(((e >> 8) * v).sum())
        assert 256 * int(hi) + int(lo) == int((e * v).sum())
    e = rng.integers(0, (1 << 15) + 1, n)
    v = rng.integers(-128, 128, n)
    lo = np.sum(((e & 255) * v).astype(np.int32), dtype=np.int32)
    hi = np.sum(((e >> 8) * v).astype(np.int32), dtype=np.int32)
    assert 256 * int(hi) + int(lo) == int((e * v).sum())
    assert n * (1 << 15) < 2 ** 31 <= (n + 1) * (1 << 15)
    assert 256 * (1 << 15) * 128 < 2 ** 31      # a decode chunk


def test_wrappers_refuse_what_the_integers_cannot_hold():
    """The range checks, reached with CPU tensors through the wrappers'
    validation."""
    q = torch.zeros((1, 1, 4, 16), dtype=torch.int8)
    k = torch.zeros((1, 1, 65536, 16), dtype=torch.int8)
    s = torch.tensor(0.01)
    luts = (_t(EXP), _t(RECIP))
    with pytest.raises(ValueError, match="65535"):
        splitmax_attn._check(q, k, k, s, s, *luts, TCFG, 65536)
    splitmax_attn._check(q, k, k, s, s, *luts, TCFG, 65535)   # kv_valid cut
    wide = TLUTConfig(scale_z=SCALE_Z, exp_frac_bits=16)
    with pytest.raises(ValueError, match="exp_frac_bits"):
        splitmax_attn._check(q, k[:, :, :8], k[:, :, :8], s, s, *luts, wide, 8)
    pages = torch.zeros((3, 1, 8, 16), dtype=torch.int8)
    one = torch.ones(1, dtype=torch.int32)
    dec = (torch.zeros(1, 2, 16), torch.float32,
           {"m_z": s.reshape(1), "s_q": s.reshape(1)}, pages, pages,
           torch.ones(1, 2, dtype=torch.int32), s, one, *luts)
    splitmax_decode._check(*dec, TCFG, None, tokens=1,
                           threads=splitmax_decode.THREADS)
    with pytest.raises(ValueError, match="exp_frac_bits"):
        splitmax_decode._check(*dec, wide, None, tokens=1,
                               threads=splitmax_decode.THREADS)


def test_verify_shape_check_states_its_limit():
    """The verify kernels' limit is their shared memory (group x T x D <=
    VERIFY_MAX_ROWS_D, D a multiple of 16 up to MAX_HEAD_DIM), not a thread
    count: the shapes the first kernel refused pass, the limit itself
    passes, one token past it raises with the limit in the message; the
    decode's limit is unchanged."""
    limit = splitmax_decode.VERIFY_MAX_ROWS_D
    assert limit == 16384 and splitmax_decode.MAX_HEAD_DIM == 256
    s = torch.tensor(0.01)
    luts = (_t(EXP), _t(RECIP))

    def check(hq, hkv, gamma, d):
        q = torch.zeros((2, hq, gamma, d))
        pages = torch.zeros((3, hkv, 32, d), dtype=torch.int8)
        per = torch.full((2, gamma), 0.01)
        splitmax_decode._check(
            q, torch.float32, {"m_z": per, "s_q": per}, pages, pages,
            torch.ones((2, 2), dtype=torch.int32), s,
            torch.ones(2, dtype=torch.int32), *luts, TCFG, None,
            tokens=gamma, threads=None)

    check(32, 4, 16, 64)                 # T 16 at group 8, D 64
    check(32, 4, 8, 128)                 # T 8 at group 8, D 128
    check(8, 1, 32, 64)                  # group 8 x 32 x 64 = the limit
    check(2, 1, 1, 256)                  # the widest head
    for shape in ((8, 1, 33, 64), (8, 1, 17, 128), (2, 1, 1, 272),
                  (8, 1, 4, 24)):
        with pytest.raises(ValueError, match=str(limit)):
            check(*shape)
    pages = torch.zeros((3, 1, 8, 256), dtype=torch.int8)
    for hq in (8, 16):                    # group x D: 2048 passes, 4096 not
        dec = (torch.zeros(1, hq, 256), torch.float32,
               {"m_z": s.reshape(1), "s_q": s.reshape(1)}, pages, pages,
               torch.ones(1, 2, dtype=torch.int32), s,
               torch.ones(1, dtype=torch.int32), *luts, TCFG, None)
        if hq == 8:
            splitmax_decode._check(*dec, tokens=1,
                                   threads=splitmax_decode.THREADS)
        else:
            with pytest.raises(ValueError, match="2048"):
                splitmax_decode._check(*dec, tokens=1,
                                       threads=splitmax_decode.THREADS)
