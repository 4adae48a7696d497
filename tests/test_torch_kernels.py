"""Kernel modules of the PyTorch port against the JAX reference.

The port's plain versions of the prefill and fused paged decode kernels
are fed the same numpy inputs as ``repro.kernels.ops`` in its ``xla``
(blocked) and ``interpret`` (the Pallas kernel body) implementations.
Integer stages are equal; f32 outputs agree to ``rtol = atol = 2e-5``, the
reference's own kernel-test tolerance, because the e*V and denominator
partial sums are taken in another order.  The CUDA kernels are held
against these plain versions in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import paged_kv as jpaged
from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro_torch.core import lut as tlut
from repro_torch.core import paged_kv as tpaged
from repro_torch.core import quantization as tq
from repro_torch.core.lut import LUTConfig as TLUTConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import splitmax_attn, splitmax_decode

torch.set_num_threads(1)

SCALE_Z = 2.6 / 127
JCFG = jlut.LUTConfig(scale_z=SCALE_Z)
TCFG = TLUTConfig(scale_z=SCALE_Z)
EXP = tlut.build_exp_lut(TCFG)
RECIP = tlut.build_recip_lut(TCFG)
SCALES = (np.float32(0.01), np.float32(0.012), np.float32(0.02))
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(rng, b, hq, hkv, sq, sk, d):
    q = rng.integers(-128, 128, (b, hq, sq, d)).astype(np.int8)
    k = rng.integers(-128, 128, (b, hkv, sk, d)).astype(np.int8)
    v = rng.integers(-128, 128, (b, hkv, sk, d)).astype(np.int8)
    return q, k, v


def _prefill_both(q, k, v, *, impl, block_q=128, block_k=128, **kw):
    jargs = (q, k, v, *(jnp.float32(s) for s in SCALES), EXP, RECIP)
    jkw = dict(kw)
    if kw.get("kv_valid_len") is not None:
        jkw["kv_valid_len"] = jnp.int32(kw["kv_valid_len"])
    want = jops.splitmax_attention(*jargs, cfg=JCFG, impl=impl,
                                   block_q=block_q, block_k=block_k, **jkw)
    got = tops.splitmax_attention(_t(q), _t(k), _t(v),
                                  *(torch.tensor(s) for s in SCALES),
                                  _t(EXP), _t(RECIP), cfg=TCFG, **kw)
    return got.numpy(), np.asarray(want)


PREFILL_GRID = [
    # b, hq, hkv, sq, sk, d
    (1, 1, 1, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 8, 128, 256, 128),     # MHA, rectangular
    (1, 4, 1, 256, 128, 32),      # MQA, narrow head
    (1, 8, 2, 250, 250, 16),      # ragged: the serving prompt length
    (2, 4, 2, 33, 33, 64),        # one past a 32-row tile
]


@pytest.mark.parametrize("shape", PREFILL_GRID)
@pytest.mark.parametrize("mode", ["causal", "bidir", "window"])
def test_prefill_plain_matches_xla(rng, shape, mode):
    b, hq, hkv, sq, sk, d = shape
    q, k, v = _qkv(rng, b, hq, hkv, sq, sk, d)
    got, want = _prefill_both(q, k, v, impl="xla", causal=mode != "bidir",
                              window=48 if mode == "window" else None)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["causal", "window"])
def test_prefill_plain_matches_interpret(rng, mode):
    """The Pallas kernel body itself (interpret mode), GQA group 2."""
    q, k, v = _qkv(rng, 1, 4, 2, 64, 64, 16)
    got, want = _prefill_both(q, k, v, impl="interpret", block_q=32,
                              block_k=32, causal=True,
                              window=24 if mode == "window" else None)
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_kv_valid_len(rng):
    q, k, v = _qkv(rng, 1, 2, 2, 96, 256, 64)
    got, want = _prefill_both(q, k, v, impl="xla", causal=False,
                              kv_valid_len=100)
    np.testing.assert_allclose(got, want, **TOL)
    # padding past kv_valid_len is invisible: same as physically truncating
    trunc = tops.splitmax_attention(
        _t(q), _t(k[:, :, :100]), _t(v[:, :, :100]),
        *(torch.tensor(s) for s in SCALES), _t(EXP), _t(RECIP), cfg=TCFG,
        causal=False)
    np.testing.assert_array_equal(got, trunc.numpy())


def test_integer_stages_bit_equal(rng):
    """int8 q from float, z32 (exact f32 products in the port), z_q and the
    exp-LUT values are bit-equal to the reference's integer datapath."""
    x = rng.normal(size=(2, 4, 40, 64)).astype(np.float32)
    kx = rng.normal(size=(2, 4, 40, 64)).astype(np.float32)
    s_q, s_k = jq.absmax_scale(jnp.asarray(x)), jq.absmax_scale(jnp.asarray(kx))
    jq_q, jk_q = jq.quantize(jnp.asarray(x), s_q), jq.quantize(jnp.asarray(kx), s_k)
    t_sq, t_sk = tq.absmax_scale(_t(x)), tq.absmax_scale(_t(kx))
    tq_q, tk_q = tq.quantize(_t(x), t_sq), tq.quantize(_t(kx), t_sk)
    np.testing.assert_array_equal(tq_q.numpy(), np.asarray(jq_q))
    z32_j = jnp.einsum("bhqd,bhkd->bhqk", jq_q.astype(jnp.int32),
                       jk_q.astype(jnp.int32))
    z32_t = tq_q.float() @ tk_q.float().transpose(-1, -2)
    np.testing.assert_array_equal(z32_t.numpy().astype(np.int64),
                                  np.asarray(z32_j).astype(np.int64))
    m_j = s_q * s_k / (jnp.sqrt(jnp.float32(64)) * SCALE_Z)
    m_t = tops.requant_multiplier(t_sq, t_sk, 64, TCFG)
    zq_j = jq.requantize_int32(z32_j, m_j)
    zq_t = tq.requantize_int32(z32_t, m_t)
    np.testing.assert_array_equal(zq_t.numpy(), np.asarray(zq_j))
    np.testing.assert_array_equal(
        tlut.exp_lookup(zq_t, _t(EXP)).numpy(),
        np.asarray(jlut.exp_lookup(zq_j, jnp.asarray(EXP))))


# ---------------------------------------------------------------- decode --

def _pool(rng, b, hkv, mb, d, bk):
    """Pool of 1 + b*mb blocks; slots own a shuffled set of non-trash
    blocks."""
    nb = 1 + b * mb
    kp = rng.integers(-128, 128, (nb, hkv, bk, d)).astype(np.int8)
    vp = rng.integers(-128, 128, (nb, hkv, bk, d)).astype(np.int8)
    table = rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
    return kp, vp, table.astype(np.int32)


def _decode_both(q, kp, vp, table, lens, *, impl, window=None):
    s_q = jq.absmax_scale(jnp.asarray(q), axis=(1, 2))
    want = jops.splitmax_decode_fused_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        s_q, jnp.float32(SCALES[1]), jnp.float32(SCALES[2]),
        jnp.asarray(lens, jnp.int32), EXP, RECIP, cfg=JCFG, window=window,
        impl=impl)
    t_sq = tq.absmax_scale(_t(q), axis=(1, 2))
    got = tops.splitmax_decode_fused_paged(
        _t(q), _t(kp), _t(vp), _t(table), t_sq, torch.tensor(SCALES[1]),
        torch.tensor(SCALES[2]), _t(np.asarray(lens, np.int32)), _t(EXP),
        _t(RECIP), cfg=TCFG, window=window)
    return got.numpy(), np.asarray(want)


DECODE_GRID = [
    # b, hq, hkv, mb, d, bk
    (2, 4, 2, 3, 64, 32),
    (3, 8, 2, 4, 16, 8),          # the smoke model's heads
    (1, 8, 1, 2, 128, 64),
    (4, 32, 4, 3, 64, 32),        # TinyLlama-1.1B's heads
]


@pytest.mark.parametrize("shape", DECODE_GRID)
@pytest.mark.parametrize("window", [None, 20])
def test_decode_plain_matches_xla(rng, shape, window):
    b, hq, hkv, mb, d, bk = shape
    kp, vp, table = _pool(rng, b, hkv, mb, d, bk)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    # lengths off and on block boundaries, and the full table
    lens = [1 + (i * 37) % (mb * bk) for i in range(b)]
    lens[0] = bk
    lens[-1] = mb * bk
    got, want = _decode_both(q, kp, vp, table, lens, impl="xla",
                             window=window)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("window", [None, 12])
def test_decode_plain_matches_interpret(rng, window):
    """The Pallas kernel body itself (interpret mode)."""
    b, hq, hkv, mb, d, bk = 2, 8, 2, 3, 16, 8
    kp, vp, table = _pool(rng, b, hkv, mb, d, bk)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    got, want = _decode_both(q, kp, vp, table, [13, 24], impl="interpret",
                             window=window)
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_trash_tail_at_block_boundary(rng):
    """Rows end on the trash block with the length exactly on a block
    boundary (tests/test_paged_kv.py's regression): the output equals the
    reference's and does not depend on what block 0 holds."""
    b, hq, hkv, d, bk = 2, 4, 2, 64, 32
    kp, vp, _ = _pool(rng, b, hkv, 2, d, bk)
    table = np.asarray([[1, 2, jpaged.TRASH_BLOCK],
                        [3, 4, jpaged.TRASH_BLOCK]], np.int32)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    outs = []
    for fill in (0, 127, -128):
        kp[tpaged.TRASH_BLOCK] = fill
        vp[tpaged.TRASH_BLOCK] = fill
        got, want = _decode_both(q, kp, vp, table, [2 * bk, 2 * bk],
                                 impl="xla")
        np.testing.assert_allclose(got, want, **TOL)
        outs.append(got)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_decode_idle_slot_reads_no_trash(rng):
    """An idle slot (row all trash, length 1 after its step) gets an
    all-zero row whatever block 0 holds; its neighbours are unaffected."""
    b, hq, hkv, mb, d, bk = 3, 8, 2, 3, 16, 8
    kp, vp, table = _pool(rng, b, hkv, mb, d, bk)
    table[1] = tpaged.TRASH_BLOCK
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kp[tpaged.TRASH_BLOCK] = 127
    vp[tpaged.TRASH_BLOCK] = 127
    got, want = _decode_both(q, kp, vp, table, [17, 1, 24], impl="xla")
    assert not got[1].any()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], **TOL)


def test_cpu_tensors_take_plain_and_count_no_launch(rng):
    splitmax_attn.launches = 0
    splitmax_decode.launches = 0
    q, k, v = _qkv(rng, 1, 2, 1, 16, 16, 16)
    _prefill_both(q, k, v, impl="xla")
    kp, vp, table = _pool(rng, 1, 1, 2, 16, 8)
    _decode_both(rng.normal(size=(1, 2, 16)).astype(np.float32), kp, vp,
                 table, [9], impl="xla")
    assert splitmax_attn.launches == 0 and splitmax_decode.launches == 0


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    q, k, v = (_t(x) for x in _qkv(rng, 1, 2, 1, 16, 16, 16))
    s = torch.tensor(0.01)
    with pytest.raises(ValueError):
        splitmax_attn.splitmax_attention_cuda(q, k, v, s, s, _t(EXP),
                                              _t(RECIP), cfg=TCFG)
    with pytest.raises(ValueError):
        splitmax_decode.splitmax_decode_fused_paged_cuda(
            torch.zeros(1, 2, 16), k[0], v[0], torch.zeros(1, 2, dtype=torch.int32),
            s.reshape(1), s.reshape(1), s, torch.ones(1, dtype=torch.int32),
            _t(EXP), _t(RECIP), cfg=TCFG)
