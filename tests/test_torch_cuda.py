"""The port's CUDA kernels against their plain PyTorch versions, on the card:
prefill, fused and composed decode over the paged pool and the dense cache,
paged and dense verify (each verify row also bit for bit the decode kernel
at its effective length, the composed decode bit for bit the fused one, and
a dense slot bit for bit a paged slot holding the same K/V), the int8 GEMM
(bit for bit) and the CIM products through it, and smoke-size serving
through them.

Every test here is marked ``gpu`` and skips without a CUDA device; this
file imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Every split-softmax kernel sums e*V and e exactly in integers, so it
equals its plain version's ``exact=True`` mode bit for bit (``torch.equal``)
at every shape and edge here, and at D 16, 32, 64, 80 and 128.  Against the
default plain version the tolerance is ``rtol = atol = 2e-5`` at ``s_v =
0.02`` (output scale up to 127 * s_v = 2.54): the default rounds its f32
partial sums of e*V, the kernel does not; integer stages are identical.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import paged_kv
from repro_torch.core import quantization as qlib
from repro_torch.core.lut import LUTConfig, build_exp_lut, build_recip_lut
from repro_torch.kernels import (int8_matmul, ops, splitmax_attn,
                                 splitmax_decode)

CFG = LUTConfig(scale_z=8.0 / 127)
SCALES = (0.01, 0.012, 0.02)
TOL = dict(rtol=2e-5, atol=2e-5)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch import resolve_device
    return resolve_device("cuda")


def _luts(dev):
    return (torch.from_numpy(build_exp_lut(CFG)).to(dev),
            torch.from_numpy(build_recip_lut(CFG)).to(dev))


def _i8(rng, shape, dev):
    return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)
                            ).to(dev)


@pytest.mark.parametrize("shape", [
    # b, hq, hkv, sq, sk, d
    (1, 32, 4, 250, 250, 64),     # the serving prefill
    (2, 8, 2, 100, 100, 16),      # the smoke model's heads
    (1, 8, 8, 128, 256, 128),     # MHA, rectangular
    (1, 4, 1, 1, 1, 32),          # one token
    (2, 4, 2, 33, 33, 64),        # one past a 32-row tile
    (8, 32, 4, 282, 282, 64),     # the dense path's re-prefill
    (1, 4, 1, 70, 130, 32),       # MQA, rectangular, ragged tiles
    (2, 4, 2, 65, 65, 80),        # one past a 64-row block, D 80
    (1, 2, 1, 40, 40, 256),       # the widest head
])
@pytest.mark.parametrize("mode", ["causal", "bidir", "window", "kv_valid"])
def test_prefill_kernel_matches_plain(rng, cuda, shape, mode):
    b, hq, hkv, sq, sk, d = shape
    q, k, v = (_i8(rng, s, cuda) for s in
               ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    m_z = ops.requant_multiplier(torch.tensor(SCALES[0], device=cuda),
                                 torch.tensor(SCALES[1], device=cuda), d,
                                 CFG).reshape(())
    args = (q, k, v, m_z, torch.tensor(SCALES[2], device=cuda), *_luts(cuda))
    kw = dict(cfg=CFG, causal=mode != "bidir",
              window=24 if mode == "window" else None,
              kv_valid_len=(sk + 1) // 2 if mode == "kv_valid" else None)
    before = splitmax_attn.launches
    got = splitmax_attn.splitmax_attention_cuda(*args, **kw)
    want = splitmax_attn.splitmax_attention_plain(*args, **kw)
    exact = splitmax_attn.splitmax_attention_plain(*args, exact=True, **kw)
    torch.cuda.synchronize()
    assert splitmax_attn.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, exact)


@pytest.mark.parametrize("shape", [
    # b, hq, hkv, mb, d, bk
    (8, 32, 4, 10, 64, 32),       # the serving decode
    (3, 8, 2, 4, 16, 8),          # the smoke model's heads
    (1, 8, 1, 2, 128, 64),
])
@pytest.mark.parametrize("window", [None, 20])
def test_decode_kernel_matches_plain_and_never_reads_trash(rng, cuda, shape,
                                                           window):
    b, hq, hkv, mb, d, bk = shape
    nb = 1 + b * mb
    kp, vp = _i8(rng, (nb, hkv, bk, d), cuda), _i8(rng, (nb, hkv, bk, d), cuda)
    kp[paged_kv.TRASH_BLOCK] = 127
    vp[paged_kv.TRASH_BLOCK] = 127
    lens = [1 + (i * 37) % (mb * bk) for i in range(b)]
    lens[0] = bk                                  # on a block boundary
    table = np.zeros((b, mb), np.int32)
    ids = rng.permutation(np.arange(1, nb))
    for i, n in enumerate(lens):
        live = paged_kv.blocks_per_seq(n, bk)
        table[i, :live] = ids[i * mb:i * mb + live]
    if b > 1:
        table[-1] = paged_kv.TRASH_BLOCK          # an idle slot
        lens[-1] = 1
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32)).to(cuda)
    s_q = qlib.absmax_scale(q, axis=(1, 2)).reshape(-1)
    s_k = torch.tensor(SCALES[1], device=cuda)
    args = [q, kp, vp, torch.from_numpy(table).to(cuda),
            ops.requant_multiplier(s_q, s_k, d, CFG), s_q,
            torch.tensor(SCALES[2], device=cuda),
            torch.tensor(lens, dtype=torch.int32, device=cuda), *_luts(cuda)]
    before = splitmax_decode.launches
    got = splitmax_decode.splitmax_decode_fused_paged_cuda(*args, cfg=CFG,
                                                           window=window)
    want = splitmax_decode.splitmax_decode_fused_paged_plain(*args, cfg=CFG,
                                                             window=window)
    kp[paged_kv.TRASH_BLOCK] = -77
    vp[paged_kv.TRASH_BLOCK] = -77
    again = splitmax_decode.splitmax_decode_fused_paged_cuda(*args, cfg=CFG,
                                                             window=window)
    torch.cuda.synchronize()
    assert splitmax_decode.launches == before + 2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)
    if b > 1:
        assert not got[-1].any()


def test_wrappers_raise_on_bad_input(rng, cuda):
    q, k, v = (_i8(rng, s, cuda) for s in
               ((1, 2, 16, 16), (1, 1, 16, 16), (1, 1, 16, 16)))
    s = torch.tensor(0.01, device=cuda)
    luts = _luts(cuda)
    bad = [
        (q.float(), k, v),                                  # float q
        (q[..., :8].contiguous(), k[..., :8].contiguous(),
         v[..., :8].contiguous()),                          # head_dim 8
        (q.transpose(2, 3), k, v),                          # not contiguous
        (q.cpu(), k, v),                                    # mixed devices
    ]
    for qq, kk, vv in bad:
        with pytest.raises(ValueError):
            splitmax_attn.splitmax_attention_cuda(qq, kk, vv, s, s, *luts,
                                                  cfg=CFG)
    pages = _i8(rng, (3, 1, 8, 16), cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                         # bf16 q
        splitmax_decode.splitmax_decode_fused_paged_cuda(
            torch.zeros(1, 2, 16, device=cuda, dtype=torch.bfloat16), pages,
            pages, torch.ones(1, 2, dtype=torch.int32, device=cuda),
            s.reshape(1), s.reshape(1), s, one, *luts, cfg=CFG)


def _paged_case(rng, dev, lens, hq, hkv, d, bk, *, idle=()):
    """A shuffled pool, table rows one entry wider than the longest slot
    (rows end in trash), block 0 poisoned with 127; ``idle`` slots own no
    block."""
    b = len(lens)
    mb = paged_kv.blocks_per_seq(max(lens), bk) + 1
    nb = 1 + b * mb
    kp, vp = _i8(rng, (nb, hkv, bk, d), dev), _i8(rng, (nb, hkv, bk, d), dev)
    kp[paged_kv.TRASH_BLOCK] = 127
    vp[paged_kv.TRASH_BLOCK] = 127
    table = np.zeros((b, mb), np.int32)
    ids = rng.permutation(np.arange(1, nb))
    for i, n in enumerate(lens):
        if i not in idle:
            live = paged_kv.blocks_per_seq(n, bk)
            table[i, :live] = ids[i * mb:i * mb + live]
    return (kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("shape", [
    # b, hq, hkv, d, bk
    (8, 32, 4, 64, 32),           # the serving verify
    (3, 8, 2, 16, 8),             # the smoke model's heads
])
@pytest.mark.parametrize("gamma", [2, 4, 8])
@pytest.mark.parametrize("window", [None, 48])
def test_verify_kernel_matches_plain_and_decode_rows(rng, cuda, shape, gamma,
                                                     window):
    b, hq, hkv, d, bk = shape
    lens = [int(n) for n in rng.integers(251, 283, b)]
    lens[0] = gamma                               # token 0 sees one position
    lens[-1] = 2 * bk + gamma // 2                # rows straddle a boundary
    idle = (1,) if b > 2 else ()
    if idle:
        lens[1] = gamma                           # an idle slot's verify
    kp, vp, table, lens_t = _paged_case(rng, cuda, lens, hq, hkv, d, bk,
                                        idle=idle)
    q = torch.from_numpy(rng.normal(size=(b, hq, gamma, d)).astype(
        np.float32)).to(cuda)
    s_q = qlib.absmax_scale(q, axis=(1, 3))[:, 0, :, 0].contiguous()
    m_z = ops.requant_multiplier(s_q, torch.tensor(SCALES[1], device=cuda),
                                 d, CFG)
    s_v = torch.tensor(SCALES[2], device=cuda)
    args = [q, kp, vp, table, m_z, s_q, s_v, lens_t, *_luts(cuda)]
    before = splitmax_decode.verify_launches
    got = splitmax_decode.splitmax_decode_fused_verify_paged_cuda(
        *args, cfg=CFG, window=window)
    want = splitmax_decode.splitmax_decode_fused_verify_paged_plain(
        *args, cfg=CFG, window=window)
    for t in range(gamma):
        row = splitmax_decode.splitmax_decode_fused_paged_cuda(
            q[:, :, t].contiguous(), kp, vp, table, m_z[:, t].contiguous(),
            s_q[:, t].contiguous(), s_v, lens_t - (gamma - 1 - t),
            *_luts(cuda), cfg=CFG, window=window)
        assert torch.equal(got[:, :, t], row), t
    kp[paged_kv.TRASH_BLOCK] = -77
    vp[paged_kv.TRASH_BLOCK] = -77
    again = splitmax_decode.splitmax_decode_fused_verify_paged_cuda(
        *args, cfg=CFG, window=window)
    torch.cuda.synchronize()
    assert splitmax_decode.verify_launches == before + 2
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)
    if idle:
        assert not got[1].any()


@pytest.mark.parametrize("shape", [(8, 32, 4, 64, 32), (3, 8, 2, 16, 8)])
@pytest.mark.parametrize("window", [None, 20])
def test_composed_kernel_equals_fused_kernel(rng, cuda, shape, window):
    b, hq, hkv, d, bk = shape
    lens = [1 + (i * 37) % 282 for i in range(b)]
    kp, vp, table, lens_t = _paged_case(rng, cuda, lens, hq, hkv, d, bk)
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32)
                         ).to(cuda)
    s_q = qlib.absmax_scale(q, axis=(1, 2))
    m_z = ops.requant_multiplier(s_q.reshape(-1),
                                 torch.tensor(SCALES[1], device=cuda), d, CFG)
    s_v = torch.tensor(SCALES[2], device=cuda)
    q_q = qlib.quantize(q, s_q)
    before = splitmax_decode.composed_launches
    comp = splitmax_decode.splitmax_decode_paged_cuda(
        q_q, kp, vp, table, m_z, s_v, lens_t, *_luts(cuda), cfg=CFG,
        window=window)
    fused = splitmax_decode.splitmax_decode_fused_paged_cuda(
        q, kp, vp, table, m_z, s_q.reshape(-1), s_v, lens_t, *_luts(cuda),
        cfg=CFG, window=window)
    plain = splitmax_decode.splitmax_decode_paged_plain(
        q_q, kp, vp, table, m_z, s_v, lens_t, *_luts(cuda), cfg=CFG,
        window=window)
    torch.cuda.synchronize()
    assert splitmax_decode.composed_launches == before + 1
    assert torch.equal(comp, fused)
    np.testing.assert_allclose(comp.cpu().numpy(), plain.cpu().numpy(), **TOL)


def _dense_case(rng, dev, lens, hq, hkv, s_max, d, gamma=None):
    """A dense (B, Hkv, S_max, D) int8 cache and f32 queries with their
    per-slot (or per-(slot, token)) scales and multipliers."""
    b = len(lens)
    k, v = (_i8(rng, (b, hkv, s_max, d), dev) for _ in range(2))
    shape = (b, hq, d) if gamma is None else (b, hq, gamma, d)
    q = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    s_q = (qlib.absmax_scale(q, axis=(1, 2)).reshape(-1) if gamma is None
           else qlib.absmax_scale(q, axis=(1, 3))[:, 0, :, 0].contiguous())
    m_z = ops.requant_multiplier(s_q, torch.tensor(SCALES[1], device=dev),
                                 d, CFG)
    return (q, k, v, m_z, s_q, torch.tensor(SCALES[2], device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("shape", [
    # b, hq, hkv, s_max, d
    (8, 32, 4, 290, 64),          # the dense churn: no tile divides S_max
    (3, 8, 2, 36, 16),            # the smoke model's heads
    (2, 8, 1, 256, 128),
])
@pytest.mark.parametrize("window", [None, 48])
def test_dense_decode_kernels_match_plain_and_each_other(rng, cuda, shape,
                                                         window):
    b, hq, hkv, s_max, d = shape
    lens = [1 + (i * 101) % s_max for i in range(b)]
    lens[0] = s_max                               # the ragged last tile
    if b > 2:
        lens[1], lens[2] = 32, 0                  # a tile boundary; idle
    q, k, v, m_z, s_q, s_v, lens_t = _dense_case(rng, cuda, lens, hq, hkv,
                                                 s_max, d)
    luts = _luts(cuda)
    q_q = qlib.quantize(q, s_q[:, None, None])
    before = (splitmax_decode.dense_launches,
              splitmax_decode.dense_composed_launches)
    fused = splitmax_decode.splitmax_decode_fused_cuda(
        q, k, v, m_z, s_q, s_v, lens_t, *luts, cfg=CFG, window=window)
    comp = splitmax_decode.splitmax_decode_cuda(
        q_q, k, v, m_z, s_v, lens_t, *luts, cfg=CFG, window=window)
    want = splitmax_decode.splitmax_decode_fused_plain(
        q, k, v, m_z, s_q, s_v, lens_t, *luts, cfg=CFG, window=window)
    torch.cuda.synchronize()
    assert (splitmax_decode.dense_launches,
            splitmax_decode.dense_composed_launches) == (before[0] + 1,
                                                         before[1] + 1)
    np.testing.assert_allclose(fused.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(comp, fused)
    if b > 2:
        assert not fused[2].any()


@pytest.mark.parametrize("window", [None, 48])
def test_dense_decode_kernel_equals_paged_kernel(rng, cuda, window):
    """The same K/V dense and scattered into a shuffled pool with block_k
    equal to the dense tile: equal bits."""
    b, hq, hkv, d, bk = 8, 32, 4, 64, splitmax_decode.DENSE_BLOCK_K
    mb = 10
    lens = [int(n) for n in rng.integers(251, 283, b)]
    lens[0], lens[1] = 1, bk
    q, k, v, m_z, s_q, s_v, lens_t = _dense_case(rng, cuda, lens, hq, hkv,
                                                 mb * bk - 7, d)
    nb = 1 + b * mb
    table = torch.from_numpy(rng.permutation(np.arange(1, nb)).reshape(
        b, mb).astype(np.int32)).to(cuda)
    kp = torch.zeros((nb, hkv, bk, d), dtype=torch.int8, device=cuda)
    vp = torch.zeros_like(kp)
    pad = (0, 0, 0, mb * bk - k.shape[2])
    for src, dst in ((k, kp), (v, vp)):
        tiles = torch.nn.functional.pad(src, pad).reshape(b, hkv, mb, bk, d)
        dst[table.long()] = tiles.permute(0, 2, 1, 3, 4)
    luts = _luts(cuda)
    dense = splitmax_decode.splitmax_decode_fused_cuda(
        q, k, v, m_z, s_q, s_v, lens_t, *luts, cfg=CFG, window=window)
    paged = splitmax_decode.splitmax_decode_fused_paged_cuda(
        q, kp, vp, table, m_z, s_q, s_v, lens_t, *luts, cfg=CFG,
        window=window)
    torch.cuda.synchronize()
    assert torch.equal(dense, paged)


@pytest.mark.parametrize("gamma", [2, 4, 8])
@pytest.mark.parametrize("window", [None, 48])
def test_dense_verify_kernel_matches_plain_and_decode_rows(rng, cuda, gamma,
                                                           window):
    b, hq, hkv, s_max, d = 8, 32, 4, 290, 64
    lens = [int(n) for n in rng.integers(251, 283, b)]
    lens[0], lens[1], lens[2] = gamma, s_max, 64 + gamma // 2
    q, k, v, m_z, s_q, s_v, lens_t = _dense_case(rng, cuda, lens, hq, hkv,
                                                 s_max, d, gamma)
    luts = _luts(cuda)
    before = splitmax_decode.dense_verify_launches
    got = splitmax_decode.splitmax_decode_fused_verify_cuda(
        q, k, v, m_z, s_q, s_v, lens_t, *luts, cfg=CFG, window=window)
    want = splitmax_decode.splitmax_decode_fused_verify_plain(
        q, k, v, m_z, s_q, s_v, lens_t, *luts, cfg=CFG, window=window)
    for t in range(gamma):
        row = splitmax_decode.splitmax_decode_fused_cuda(
            q[:, :, t].contiguous(), k, v, m_z[:, t].contiguous(),
            s_q[:, t].contiguous(), s_v, lens_t - (gamma - 1 - t), *luts,
            cfg=CFG, window=window)
        assert torch.equal(got[:, :, t], row), t
    torch.cuda.synchronize()
    assert splitmax_decode.dense_verify_launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.parametrize("m,k,n", [
    (256, 512, 256), (128, 128, 128), (512, 256, 384),   # the reference's
    (37, 100, 70),                                       # ragged edges
    (300, 2048, 260),                                    # |acc| past 2^24
    (1, 16, 5),                                          # M 1, N < 8
    (64, 48, 256),                                       # K below one tile
    (129, 272, 264),                                     # ragged every edge
    (256, 4096, 512),                                    # |acc| up to 2^26
])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul_kernel_equals_plain(rng, cuda, m, k, n, requant):
    x, w = _i8(rng, (m, k), cuda), _i8(rng, (k, n), cuda)
    x[0], w[:, 0] = -128, -128
    _int8_matmul_case(cuda, x, w, requant)


def _int8_matmul_case(cuda, x, w, requant):
    k = x.shape[1]
    mult = torch.tensor(3.7e-6 if k >= 2048 else 3.7e-4, device=cuda)
    mult = mult if requant else None
    before = (int8_matmul.launches, int8_matmul.pack_launches)
    got = int8_matmul.int8_matmul_cuda(x, w, mult)
    want = int8_matmul.int8_matmul_plain(x, w, mult)
    torch.cuda.synchronize()
    assert (int8_matmul.launches, int8_matmul.pack_launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == (torch.int8 if requant else torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(0, 64, 32), (16, 64, 0), (16, 0, 32)])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul_kernel_empty_launches_nothing(rng, cuda, m, k, n,
                                                   requant):
    """An empty output, or K 0 (every sum zero), launches neither kernel and
    counts nothing."""
    x, w = _i8(rng, (m, k), cuda), _i8(rng, (k, n), cuda)
    mult = torch.tensor(3.7e-4, device=cuda) if requant else None
    before = (int8_matmul.launches, int8_matmul.pack_launches)
    got = int8_matmul.int8_matmul_cuda(x, w, mult)
    torch.cuda.synchronize()
    assert (int8_matmul.launches, int8_matmul.pack_launches) == before
    assert torch.equal(got, int8_matmul.int8_matmul_plain(x, w, mult))


@pytest.mark.parametrize("m,k,n", [(37, 100, 70), (129, 272, 264)])
def test_int8_matmul_launches_counted_by_each_wrapper(rng, cuda, m, k, n):
    """The pre-pass and the body, called apart, each count their own launch
    and no other, and each equals its plain version."""
    x, w = _i8(rng, (m, k), cuda), _i8(rng, (k, n), cuda)
    before = (int8_matmul.launches, int8_matmul.pack_launches)
    w_t = int8_matmul.pack_k_major_cuda(w)
    torch.cuda.synchronize()
    assert (int8_matmul.launches, int8_matmul.pack_launches) == (
        before[0], before[1] + 1)
    assert torch.equal(w_t, int8_matmul.pack_k_major_plain(w))
    x_p = torch.zeros((m, w_t.shape[1]), dtype=torch.int8, device=cuda)
    x_p[:, :k] = x
    got = int8_matmul.int8_matmul_packed_cuda(x_p, w_t)
    torch.cuda.synchronize()
    assert (int8_matmul.launches, int8_matmul.pack_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, int8_matmul.int8_matmul_plain(x, w))


@pytest.mark.parametrize("m,k,n", [(70, 100, 96), (33, 128, 40)])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul_kernel_unaligned_x(rng, cuda, m, k, n, requant):
    """An x_q whose base is not 16-byte aligned goes through the zero-padded
    copy, with K % 16 != 0 (a row view) and with K % 16 == 0 (a flat
    view one byte in)."""
    if k % 16:
        x = _i8(rng, (m + 1, k), cuda)[1:]
    else:
        x = _i8(rng, (m * k + 1,), cuda)[1:].view(m, k)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = _i8(rng, (k, n), cuda)
    x[0], w[:, 0] = -128, -128
    _int8_matmul_case(cuda, x, w, requant)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("m, k, n", [(32, 48, 24), (3, 1000, 130),
                                     (64, 256, 512)])
def test_cim_products_through_the_int8_gemm(rng, cuda, m, k, n):
    """The CIM datapath model on the card: the nibble split is two launches
    of kernel 8's body (each on its own pre-pass) and the bit-serial form
    eight on one pre-pass, both bit for bit the int32 product."""
    from repro_torch.core import cim
    x, w = _i8(rng, (m, k), cuda), _i8(rng, (k, n), cuda)
    want = int8_matmul.int8_matmul_plain(x, w)
    for fn, launches in ((cim.nibble_split_matmul, (2, 2)),
                         (cim.serial_bit_matmul, (8, 1))):
        before = (int8_matmul.launches, int8_matmul.pack_launches)
        got = fn(x, w)
        after = (int8_matmul.launches, int8_matmul.pack_launches)
        assert tuple(a - b for a, b in zip(after, before)) == launches
        assert torch.equal(got, want)


def test_smoke_speculative_serving_runs_through_the_kernels(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    cfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    params = _tree_to(cpu_params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 20, dtype=np.int32)
               for _ in range(6)]
    gens = [int(g) for g in rng.integers(6, 13, 6)]
    plain = srv.serve_paged(params, cfg, prompts, slots=3, gen=12, gens=gens,
                            block_k=8)
    splitmax_decode.verify_launches = 0
    stats = srv.serve(params, cfg, prompts, slots=3, gen=12, gens=gens,
                      block_k=8, draft="self", gamma=3)
    assert stats["served"] == 6 and stats["leaked_blocks"] == 0
    assert splitmax_decode.verify_launches == (stats["verify_steps"]
                                               * cfg.n_layers)
    assert stats["finished"] == plain["finished"]
    splitmax_decode.composed_launches = 0
    composed = srv.serve_paged(params, cfg.replace(attn_fused=False), prompts,
                               slots=3, gen=12, gens=gens, block_k=8)
    assert splitmax_decode.composed_launches == (composed["decode_steps"]
                                                 * cfg.n_layers)
    assert composed["finished"] == plain["finished"]


def test_smoke_serving_runs_through_the_kernels(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    cfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 20, dtype=np.int32)
               for _ in range(6)]
    gens = [int(g) for g in rng.integers(6, 13, 6)]
    splitmax_attn.launches = splitmax_decode.launches = 0
    stats = srv.serve_paged(_tree_to(cpu_params, cuda), cfg, prompts, slots=3,
                            gen=12, gens=gens, block_k=8)
    assert stats["served"] == 6 and stats["leaked_blocks"] == 0
    assert splitmax_attn.launches == stats["slot_prefills"] * cfg.n_layers
    assert splitmax_decode.launches == stats["decode_steps"] * cfg.n_layers
    # the same weights on the CPU (plain versions) give the same tokens
    cpu_stats = srv.serve_paged(cpu_params, cfg, prompts, slots=3, gen=12,
                                gens=gens, block_k=8)
    assert stats["finished"] == cpu_stats["finished"]


def test_smoke_dense_serving_runs_through_the_kernels(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as srv
    from repro_torch.models import transformer as T

    cfg = get_arch("tinyllama_1p1b").smoke.replace(dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    params = _tree_to(cpu_params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 20, dtype=np.int32)
               for _ in range(6)]
    gens = [int(g) for g in rng.integers(6, 13, 6)]
    for fused in (True, False):
        c = cfg.replace(attn_fused=fused)
        splitmax_attn.launches = 0
        splitmax_decode.dense_launches = 0
        splitmax_decode.dense_composed_launches = 0
        stats = srv.serve(params, c, prompts, slots=3, gen=12, gens=gens,
                          cache_kind="dense")
        n_dec = (splitmax_decode.dense_launches if fused
                 else splitmax_decode.dense_composed_launches)
        assert stats["served"] == 6
        assert splitmax_attn.launches == stats["batch_prefills"] * cfg.n_layers
        assert n_dec == stats["decode_steps"] * cfg.n_layers
        cpu_stats = srv.serve(cpu_params, c, prompts, slots=3, gen=12,
                              gens=gens, cache_kind="dense")
        assert stats["finished"] == cpu_stats["finished"]


# ------------------------------------------------- the exact oracle, bitwise --

def _decode_lens(bk, s_max):
    """Lengths 0 (idle), 1, 4, a tile boundary, one past it, two tiles, the
    serving length, and the end of the cache."""
    return [0, 1, 4, bk, bk + 1, 2 * bk, min(250, s_max), s_max]


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("window", [None, 48])
def test_paged_decode_kernels_equal_exact_oracle(rng, cuda, d, window):
    hq, hkv, bk = (32, 4, 32) if d < 128 else (8, 1, 32)
    lens = _decode_lens(bk, 282)
    kp, vp, table, lens_t = _paged_case(rng, cuda, [max(n, 1) for n in lens],
                                        hq, hkv, d, bk, idle=(0,))
    lens_t[0] = 0
    q = torch.from_numpy(rng.normal(size=(len(lens), hq, d)).astype(
        np.float32)).to(cuda)
    s_q = qlib.absmax_scale(q, axis=(1, 2)).reshape(-1)
    m_z = ops.requant_multiplier(s_q, torch.tensor(SCALES[1], device=cuda), d,
                                 CFG)
    s_v = torch.tensor(SCALES[2], device=cuda)
    args = [q, kp, vp, table, m_z, s_q, s_v, lens_t, *_luts(cuda)]
    fused = splitmax_decode.splitmax_decode_fused_paged_cuda(
        *args, cfg=CFG, window=window)
    want = splitmax_decode.splitmax_decode_fused_paged_plain(
        *args, cfg=CFG, window=window, exact=True)
    q_q = qlib.quantize(q, s_q[:, None, None])
    cargs = [q_q, kp, vp, table, m_z, s_v, lens_t, *_luts(cuda)]
    comp = splitmax_decode.splitmax_decode_paged_cuda(*cargs, cfg=CFG,
                                                      window=window)
    comp_want = splitmax_decode.splitmax_decode_paged_plain(
        *cargs, cfg=CFG, window=window, exact=True)
    torch.cuda.synchronize()
    assert torch.equal(fused, want)
    assert torch.equal(comp, comp_want)
    assert torch.equal(comp, fused)
    assert not fused[0].any()


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("window", [None, 48])
def test_dense_decode_kernels_equal_exact_oracle(rng, cuda, d, window):
    hq, hkv, s_max = (32, 4, 290) if d < 128 else (8, 1, 290)
    lens = _decode_lens(splitmax_decode.DENSE_BLOCK_K, s_max)
    q, k, v, m_z, s_q, s_v, lens_t = _dense_case(rng, cuda, lens, hq, hkv,
                                                 s_max, d)
    luts = _luts(cuda)
    fused = splitmax_decode.splitmax_decode_fused_cuda(
        q, k, v, m_z, s_q, s_v, lens_t, *luts, cfg=CFG, window=window)
    want = splitmax_decode.splitmax_decode_fused_plain(
        q, k, v, m_z, s_q, s_v, lens_t, *luts, cfg=CFG, window=window,
        exact=True)
    q_q = qlib.quantize(q, s_q[:, None, None])
    comp = splitmax_decode.splitmax_decode_cuda(
        q_q, k, v, m_z, s_v, lens_t, *luts, cfg=CFG, window=window)
    comp_want = splitmax_decode.splitmax_decode_plain(
        q_q, k, v, m_z, s_v, lens_t, *luts, cfg=CFG, window=window,
        exact=True)
    torch.cuda.synchronize()
    assert torch.equal(fused, want)
    assert torch.equal(comp, comp_want)
    assert not fused[0].any()


VERIFY_SHAPES = [
    # d, gamma, hq, hkv
    (16, 4, 32, 4), (32, 4, 32, 4), (64, 4, 32, 4), (128, 4, 8, 1),
    (16, 8, 32, 4), (32, 8, 32, 4), (64, 8, 32, 4),
    (128, 8, 4, 1),               # group 4: under the first kernel's cap
    (128, 8, 32, 4),              # group 8 x T 8 x D 128: past that cap
    (64, 16, 32, 4),              # group 8 x T 16 x D 64: past that cap
]


def _verify_gates(rng, dev, layout, lens, d, gamma, hq, hkv, window):
    """Run the paged or dense verify kernel on slots of ``lens``: equal to
    the ``exact=True`` plain version, every token's row equal to the decode
    kernel at its effective length, a paged result unchanged when the trash
    block is re-poisoned, and idle slots (length 0) all zero."""
    bk = 32
    q = torch.from_numpy(rng.normal(size=(len(lens), hq, gamma, d)).astype(
        np.float32)).to(dev)
    s_q = qlib.absmax_scale(q, axis=(1, 3))[:, 0, :, 0].contiguous()
    m_z = ops.requant_multiplier(s_q, torch.tensor(SCALES[1], device=dev),
                                 d, CFG)
    s_v = torch.tensor(SCALES[2], device=dev)
    luts = _luts(dev)
    idle = tuple(i for i, n in enumerate(lens) if n == 0)
    if layout == "paged":
        kp, vp, table, lens_t = _paged_case(
            rng, dev, [max(n, 1) for n in lens], hq, hkv, d, bk, idle=idle)
        lens_t[list(idle)] = 0
        cache = [kp, vp, table]
        kern = splitmax_decode.splitmax_decode_fused_verify_paged_cuda
        plain = splitmax_decode.splitmax_decode_fused_verify_paged_plain
        decode = splitmax_decode.splitmax_decode_fused_paged_cuda
    else:
        s_max = max(290, max(lens))
        cache = [_i8(rng, (len(lens), hkv, s_max, d), dev) for _ in range(2)]
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        kern = splitmax_decode.splitmax_decode_fused_verify_cuda
        plain = splitmax_decode.splitmax_decode_fused_verify_plain
        decode = splitmax_decode.splitmax_decode_fused_cuda
    args = [q, *cache, m_z, s_q, s_v, lens_t, *luts]
    got = kern(*args, cfg=CFG, window=window)
    want = plain(*args, cfg=CFG, window=window, exact=True)
    for t in range(gamma):
        row = decode(q[:, :, t].contiguous(), *cache, m_z[:, t].contiguous(),
                     s_q[:, t].contiguous(), s_v,
                     torch.clamp_min(lens_t - (gamma - 1 - t), 0), *luts,
                     cfg=CFG, window=window)
        assert torch.equal(got[:, :, t], row), t
    if layout == "paged":
        cache[0][paged_kv.TRASH_BLOCK] = -77
        cache[1][paged_kv.TRASH_BLOCK] = -77
        assert torch.equal(kern(*args, cfg=CFG, window=window), got)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for i in idle:
        assert not got[i].any(), i


@pytest.mark.parametrize("d,gamma,hq,hkv", VERIFY_SHAPES)
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_verify_kernels_equal_exact_oracle(rng, cuda, d, gamma, hq, hkv,
                                           layout):
    bk = 32
    lens = [gamma, bk, bk + gamma // 2, 2 * bk + 1, 250, 282, 96, gamma + 1]
    for window in (None, 48):
        _verify_gates(rng, cuda, layout, lens, d, gamma, hq, hkv, window)


@pytest.mark.parametrize("case", ["one live rank", "window kills ranks"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_verify_kernels_with_ranks_that_hold_no_tile(rng, cuda, case,
                                                     layout):
    """The cluster's ranks split the 32-key tiles: with every slot within
    one tile only rank 0 holds one; with a window over long slots the
    ranks of the dead tiles hold none, and the live ones start late."""
    if case == "one live rank":
        lens, window = [4, 1, 17, 32, 0, 31, 9, 4], None
    else:
        lens, window = [600, 700, 451, 480, 0, 390, 640, 513], 40
    _verify_gates(rng, cuda, layout, lens, 64, 4, 32, 4, window)


def test_decode_bits_do_not_depend_on_the_batch_or_the_table(rng, cuda):
    """Slot 3 of an 8-slot batch with a 10-entry table row, alone with a
    20-entry row and again at slot 0 of a 2-slot batch: the same bits."""
    b, hq, hkv, d, bk = 8, 32, 4, 64, 32
    lens = [int(n) for n in rng.integers(251, 283, b)]
    kp, vp, table, lens_t = _paged_case(rng, cuda, lens, hq, hkv, d, bk)
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32)
                         ).to(cuda)
    s_q = qlib.absmax_scale(q, axis=(1, 2)).reshape(-1)
    m_z = ops.requant_multiplier(s_q, torch.tensor(SCALES[1], device=cuda), d,
                                 CFG)
    s_v = torch.tensor(SCALES[2], device=cuda)
    luts = _luts(cuda)
    full = splitmax_decode.splitmax_decode_fused_paged_cuda(
        q, kp, vp, table, m_z, s_q, s_v, lens_t, *luts, cfg=CFG)
    wide = torch.zeros((1, 20), dtype=torch.int32, device=cuda)
    wide[0, :table.shape[1]] = table[3]
    alone = splitmax_decode.splitmax_decode_fused_paged_cuda(
        q[3:4].contiguous(), kp, vp, wide, m_z[3:4].contiguous(),
        s_q[3:4].contiguous(), s_v, lens_t[3:4].contiguous(), *luts, cfg=CFG)
    pair = splitmax_decode.splitmax_decode_fused_paged_cuda(
        q[[3, 5]].contiguous(), kp, vp, table[[3, 5]].contiguous(),
        m_z[[3, 5]].contiguous(), s_q[[3, 5]].contiguous(), s_v,
        lens_t[[3, 5]].contiguous(), *luts, cfg=CFG)
    torch.cuda.synchronize()
    assert torch.equal(full[3], alone[0])
    assert torch.equal(full[3], pair[0])
    assert torch.equal(full[5], pair[1])


# ------------------------------------- the options and the dense family's --

def _option_luts(dev, option):
    """The exp and recip tables an option reads: ``compute`` is the
    reference's f32 recompute as a table, built on the CPU."""
    from repro_torch.core.lut import build_exp_lut_compute
    exp, recip = _luts(dev)
    if option == "compute":
        exp = build_exp_lut_compute(CFG).to(dev)
    return exp, recip


OPTION_ENTRIES = ["prefill", "paged fused", "paged composed", "dense fused",
                  "dense composed", "paged verify", "dense verify"]


@pytest.mark.parametrize("entry", OPTION_ENTRIES)
@pytest.mark.parametrize("option", ["exact_recip", "compute"])
def test_option_instances_equal_exact_oracle(rng, cuda, entry, option):
    """Each kernel's ``kExactRecip`` instance, and each kernel reading the
    compute table, bit for bit its plain version's ``exact=True`` with the
    same option."""
    luts = _option_luts(cuda, option)
    kw = dict(cfg=CFG, window=48, exact_recip=option == "exact_recip")
    s_v = torch.tensor(SCALES[2], device=cuda)
    if entry == "prefill":
        b, hq, hkv, s, d = 1, 32, 8, 250, 128
        q, k, v = (_i8(rng, x, cuda) for x in
                   ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        m_z = ops.requant_multiplier(torch.tensor(SCALES[0], device=cuda),
                                     torch.tensor(SCALES[1], device=cuda), d,
                                     CFG).reshape(())
        args = (q, k, v, m_z, s_v, *luts)
        got = splitmax_attn.splitmax_attention_cuda(*args, **kw)
        want = splitmax_attn.splitmax_attention_plain(*args, exact=True, **kw)
    else:
        layout, kind = entry.split()
        lens = [4, 32, 33, 250, 282, 96, 1, 64]
        gamma = 4 if kind == "verify" else None
        hq, hkv, d = 32, 8, 128
        if layout == "paged":
            kp, vp, table, lens_t = _paged_case(rng, cuda, lens, hq, hkv, d, 32)
            cache = [kp, vp, table]
        else:
            q, kc, vc, *_ = _dense_case(rng, cuda, lens, hq, hkv, 290, d)
            cache = [kc, vc]
            lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
        shape = (len(lens), hq, d) if gamma is None else (len(lens), hq, gamma,
                                                          d)
        q = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                             ).to(cuda)
        s_q = (qlib.absmax_scale(q, axis=(1, 2)).reshape(-1) if gamma is None
               else qlib.absmax_scale(q, axis=(1, 3))[:, 0, :, 0].contiguous())
        m_z = ops.requant_multiplier(s_q, torch.tensor(SCALES[1],
                                                       device=cuda), d, CFG)
        name = "splitmax_decode" + ("_fused" if kind != "composed" else "") \
            + ("_verify" if gamma else "") \
            + ("_paged" if layout == "paged" else "")
        if kind == "composed":
            args = [qlib.quantize(q, s_q[:, None, None]), *cache, m_z, s_v,
                    lens_t, *luts]
        else:
            args = [q, *cache, m_z, s_q, s_v, lens_t, *luts]
        got = getattr(splitmax_decode, name + "_cuda")(*args, **kw)
        want = getattr(splitmax_decode, name + "_plain")(*args, exact=True,
                                                         **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("hq", [32, 56])
def test_kernels_at_the_dense_configs_gqa_groups(rng, cuda, hq):
    """Kernels 1-3 at Mistral-NeMo-12B's heads (32/8, group 4) and
    DeepSeek-Coder-33B's (56/8, group 7, the first odd group), D 128: the
    250-token prefill, the 8-slot decode and verify at gamma 4, each bit
    for bit its ``exact=True`` plain version."""
    hkv, d, bk = 8, 128, 32
    luts = _luts(cuda)
    s_v = torch.tensor(SCALES[2], device=cuda)
    q, k, v = (_i8(rng, x, cuda) for x in
               ((1, hq, 250, d), (1, hkv, 250, d), (1, hkv, 250, d)))
    m_z = ops.requant_multiplier(torch.tensor(SCALES[0], device=cuda),
                                 torch.tensor(SCALES[1], device=cuda), d,
                                 CFG).reshape(())
    args = (q, k, v, m_z, s_v, *luts)
    assert torch.equal(
        splitmax_attn.splitmax_attention_cuda(*args, cfg=CFG),
        splitmax_attn.splitmax_attention_plain(*args, cfg=CFG, exact=True))
    lens = [int(n) for n in rng.integers(251, 283, 8)]
    lens[0] = 4
    kp, vp, table, lens_t = _paged_case(rng, cuda, lens, hq, hkv, d, bk)
    for gamma in (None, 4):
        shape = (8, hq, d) if gamma is None else (8, hq, gamma, d)
        q = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                             ).to(cuda)
        s_q = (qlib.absmax_scale(q, axis=(1, 2)).reshape(-1) if gamma is None
               else qlib.absmax_scale(q, axis=(1, 3))[:, 0, :, 0].contiguous())
        m_z = ops.requant_multiplier(s_q, torch.tensor(SCALES[1],
                                                       device=cuda), d, CFG)
        args = [q, kp, vp, table, m_z, s_q, s_v, lens_t, *luts]
        fn = ("splitmax_decode_fused_paged" if gamma is None
              else "splitmax_decode_fused_verify_paged")
        for window in (None, 48):
            got = getattr(splitmax_decode, fn + "_cuda")(*args, cfg=CFG,
                                                         window=window)
            want = getattr(splitmax_decode, fn + "_plain")(
                *args, cfg=CFG, window=window, exact=True)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (fn, window)


@pytest.mark.parametrize("window", [None, 48])
def test_dense_decode_kernels_at_the_hybrid_head_dim(rng, cuda, window):
    """Kernels 4 and 6 at Zamba2-2.7B's shared attention (32/32 heads of
    80, group 1) over its dense churn's cache (8 slots, S_max 290), with
    the edge lengths: each bit for bit its ``exact=True`` plain version,
    the composed bit for bit the fused, and the fused bit for bit the paged
    kernel on the same K/V scattered into a pool."""
    hq = hkv = 32
    d, s_max, bk = 80, 290, splitmax_decode.DENSE_BLOCK_K
    lens = _decode_lens(bk, s_max)
    q, k, v, m_z, s_q, s_v, lens_t = _dense_case(rng, cuda, lens, hq, hkv,
                                                 s_max, d)
    luts = _luts(cuda)
    fused = splitmax_decode.splitmax_decode_fused_cuda(
        q, k, v, m_z, s_q, s_v, lens_t, *luts, cfg=CFG, window=window)
    want = splitmax_decode.splitmax_decode_fused_plain(
        q, k, v, m_z, s_q, s_v, lens_t, *luts, cfg=CFG, window=window,
        exact=True)
    q_q = qlib.quantize(q, s_q[:, None, None])
    comp = splitmax_decode.splitmax_decode_cuda(
        q_q, k, v, m_z, s_v, lens_t, *luts, cfg=CFG, window=window)
    comp_want = splitmax_decode.splitmax_decode_plain(
        q_q, k, v, m_z, s_v, lens_t, *luts, cfg=CFG, window=window,
        exact=True)
    b, mb = len(lens), -(-s_max // bk)
    nb = 1 + b * mb
    table = torch.from_numpy(rng.permutation(np.arange(1, nb)).reshape(
        b, mb).astype(np.int32)).to(cuda)
    pools = []
    for src in (k, v):
        tiles = torch.nn.functional.pad(src, (0, 0, 0, mb * bk - s_max))
        pool = torch.zeros((nb, hkv, bk, d), dtype=torch.int8, device=cuda)
        pool[table.long()] = tiles.reshape(b, hkv, mb, bk, d).permute(
            0, 2, 1, 3, 4)
        pools.append(pool)
    paged = splitmax_decode.splitmax_decode_fused_paged_cuda(
        q, *pools, table, m_z, s_q, s_v, lens_t, *luts, cfg=CFG,
        window=window)
    torch.cuda.synchronize()
    assert torch.equal(fused, want)
    assert torch.equal(comp, comp_want)
    assert torch.equal(comp, fused)
    assert torch.equal(paged, fused)
    assert not fused[0].any()


TILE_CASES = [
    # d, hq, hkv, s_max: TinyLlama's heads at 2048, Zamba2's D 80, the wide
    # group-8 D 128 shape, and a cache no candidate divides
    (64, 32, 4, 2048), (80, 32, 32, 512), (128, 64, 8, 2048),
    (64, 32, 4, 290),
]


def _tile_keys(s_max):
    from repro_torch.kernels import autotune
    return [(bk, gp) for bk in autotune.candidate_block_ks(s_max)
            for gp in autotune.CANDIDATE_G_PAD]


@pytest.mark.parametrize("d,hq,hkv,s_max", TILE_CASES)
@pytest.mark.parametrize("window", [None, 48])
def test_dense_decode_tile_instances_equal_exact_plain(rng, cuda, d, hq, hkv,
                                                       s_max, window):
    """Every tile instance of kernels 4 and 6 that the sweep can pick is
    bit for bit the ``exact=True`` plain version at that ``block_k``; a
    candidate the sweep refuses (``tile_refusal``) is refused by the
    launcher too, and a launched one is counted under its instance."""
    lens = [0, 1, 33, s_max // 2 + 5, 250, s_max - 1, s_max, 97]
    q, k, v, m_z, s_q, s_v, lens_t = _dense_case(rng, cuda, lens, hq, hkv,
                                                 s_max, d)
    q_q = qlib.quantize(q, s_q[:, None, None])
    luts = _luts(cuda)
    want = splitmax_decode.splitmax_decode_fused_plain(
        q, k, v, m_z, s_q, s_v, lens_t, *luts, cfg=CFG, window=window,
        exact=True)
    for bk, gp in _tile_keys(s_max):
        why = splitmax_decode.tile_refusal("decode", bk, gp, group=hq // hkv,
                                           d=d, s_max=s_max, cfg=CFG)
        kw = dict(cfg=CFG, window=window, block_k=bk, g_pad_min=gp)
        if why is not None:
            with pytest.raises(RuntimeError):
                splitmax_decode.splitmax_decode_fused_cuda(
                    q, k, v, m_z, s_q, s_v, lens_t, *luts, **kw)
            continue
        stage = splitmax_decode.tile_instance(bk, gp, s_max)[0]
        before = dict(splitmax_decode.tile_launches)
        got = splitmax_decode.splitmax_decode_fused_cuda(
            q, k, v, m_z, s_q, s_v, lens_t, *luts, **kw)
        comp = splitmax_decode.splitmax_decode_cuda(
            q_q, k, v, m_z, s_v, lens_t, *luts, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (bk, gp)
        assert torch.equal(comp, want), (bk, gp)
        if stage:
            key = ("decode", stage, 16)
            assert (splitmax_decode.tile_launches[key]
                    == before.get(key, 0) + 1)


@pytest.mark.parametrize("d,hq,hkv,s_max", TILE_CASES)
@pytest.mark.parametrize("gamma", [4, 8])
def test_verify_tile_instances_equal_exact_plain(rng, cuda, d, hq, hkv,
                                                 s_max, gamma):
    """Every tile instance of kernel 7 (and kernel 3's g_pad_min 16
    instance) is bit for bit the ``exact=True`` plain version, with and
    without a window; refusals agree with the launcher."""
    lens = [gamma, 33, s_max // 2 + 5, 250, s_max - 1, s_max, 97, gamma + 1]
    q, k, v, m_z, s_q, s_v, lens_t = _dense_case(rng, cuda, lens, hq, hkv,
                                                 s_max, d, gamma)
    luts = _luts(cuda)
    args = (q, k, v, m_z, s_q, s_v, lens_t, *luts)
    if hq // hkv * gamma * d > splitmax_decode.VERIFY_MAX_ROWS_D:
        pytest.skip("past the verify kernels' rows x D")
    for window in (None, 48):
        want = splitmax_decode.splitmax_decode_fused_verify_plain(
            *args, cfg=CFG, window=window, exact=True)
        for bk, gp in _tile_keys(s_max):
            why = splitmax_decode.tile_refusal(
                "verify", bk, gp, group=hq // hkv, d=d, s_max=s_max, cfg=CFG,
                tokens=gamma)
            kw = dict(cfg=CFG, window=window, block_k=bk, g_pad_min=gp)
            if why is not None:
                with pytest.raises((RuntimeError, ValueError)):
                    splitmax_decode.splitmax_decode_fused_verify_cuda(
                        *args, **kw)
                continue
            got = splitmax_decode.splitmax_decode_fused_verify_cuda(*args,
                                                                    **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (bk, gp, window)
    kp, vp, table, plens = _paged_case(rng, cuda, lens, hq, hkv, d, 32)
    pargs = (q, kp, vp, table, m_z, s_q, s_v, plens, *luts)
    before = splitmax_decode.tile_launches.get(("verify_paged", 0, 32), 0)
    got = splitmax_decode.splitmax_decode_fused_verify_paged_cuda(
        *pargs, cfg=CFG, g_pad_min=16)
    want = splitmax_decode.splitmax_decode_fused_verify_paged_plain(
        *pargs, cfg=CFG, exact=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert splitmax_decode.tile_launches[("verify_paged", 0, 32)] == \
        before + 1


def test_recorder_spans_lie_on_the_profiler_clock(cuda):
    """The recorder's stamps, moved by its drain onto the clock of
    ``torch.profiler``'s events, hold the launch (the CUDA runtime call
    that shares the kernel's correlation id) of the one kernel run inside
    a span, within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    x = torch.zeros(1 << 20, device=cuda)
    x.add_(1)
    torch.cuda.synchronize()
    trace.disable()
    trace.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace.enable()
        try:
            with trace.span("add"):
                x.add_(1)
            torch.cuda.synchronize()
            out = trace.drain()
        finally:
            trace.disable()
    span, = out["spans"]
    dev = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events
               if e.device_type() == dev and e.duration_ns() > 0]
    calls = {e.correlation_id(): e for e in events
             if e.device_type() != dev and e.correlation_id()}
    assert len(kernels) == 1, [e.name() for e in kernels]
    call = calls[kernels[0].correlation_id()]
    slack = 50_000
    assert span["t0"] - slack <= call.start_ns() <= span["t1"] + slack, (
        span["t0"], call.start_ns(), span["t1"])


# ---- the int8-weight linear (kernels/csrc/w8_linear.cu) -------------------
# The four (K, N) of DeepSeek-67B's seven layer linears (q and o, k and v,
# in and gate, out) and the rows the kernel's four instances take.
W8_SHAPES = [(8192, 8192), (8192, 1024), (8192, 22016), (22016, 8192)]
W8_ROWS = [1, 3, 8, 16, 33, 64]


@pytest.fixture(scope="module")
def w8_weights():
    """One int8 weight and its f32 scale a shape, on the card (every byte
    value, -128 included), with its ``linear_weight`` bf16 dequant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(32)
    out = {}
    for k, n in W8_SHAPES:
        w_q = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                            dtype=torch.int8)
        w_s = torch.rand((1, 1), generator=gen, device="cuda") * 0.02
        out[(k, n)] = (w_q, w_s, L.linear_weight({"w_q": w_q, "w_s": w_s},
                                                 torch.bfloat16))
    return out


def _w8_x(k, m, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("m", W8_ROWS)
@pytest.mark.parametrize("kn", W8_SHAPES)
def test_w8_linear_one_hot_rows_are_the_dequant_bits(cuda, w8_weights, kn, m):
    """(a) Row r of x a single 1.0 at column k_r: the output row is row k_r
    of ``linear_weight(params, bf16)`` bit for bit (one exact product, the
    f32 sum of it and zeros, rounded to bf16: the dequant's own bits)."""
    from repro_torch.kernels import w8_linear
    w_q, w_s, w = w8_weights[kn]
    ks = torch.randint(0, kn[0], (m,), device=cuda,
                       generator=torch.Generator(device="cuda").manual_seed(m))
    x = torch.zeros((m, kn[0]), device=cuda, dtype=torch.bfloat16)
    x[torch.arange(m, device=cuda), ks] = 1
    before = w8_linear.launches
    assert torch.equal(w8_linear.w8_linear_cuda(x, w_q, w_s), w[ks])
    assert w8_linear.launches == before + 1


@pytest.mark.parametrize("m", W8_ROWS)
@pytest.mark.parametrize("kn", W8_SHAPES)
def test_w8_linear_error_within_twice_cublas(cuda, w8_weights, kn, m):
    """(b) Against the f64 product of the same bf16 operands, the kernel's
    largest error is at most twice cuBLAS's on the same inputs.  Both sum
    the same exact bf16 products in f32 and round once to bf16; only the
    order of the sums differs, so an order much worse than cuBLAS's (or a
    wrong term) shows as a larger error."""
    from repro_torch.kernels import w8_linear
    w_q, w_s, w = w8_weights[kn]
    x = _w8_x(kn[0], m, 100 + m)
    exact = x.double() @ w.double()
    err = (w8_linear.w8_linear_cuda(x, w_q, w_s).double() - exact).abs().max()
    ref = ((x @ w).double() - exact).abs().max()
    assert float(err) <= 2 * float(ref)


@pytest.mark.parametrize("kn", W8_SHAPES)
def test_w8_linear_rows_do_not_depend_on_the_batch(cuda, w8_weights, kn):
    """(c) Each row at M 16 (and at M 64, another instance) equals that row
    computed alone at M 1, bit for bit: the split of K and every sum's
    order depend on (K, N) alone."""
    from repro_torch.kernels import w8_linear
    w_q, w_s, _ = w8_weights[kn]
    x = _w8_x(kn[0], 64, 7)
    y16 = w8_linear.w8_linear_cuda(x[:16].contiguous(), w_q, w_s)
    y64 = w8_linear.w8_linear_cuda(x, w_q, w_s)
    for r in range(16):
        alone = w8_linear.w8_linear_cuda(x[r:r + 1].contiguous(), w_q, w_s)
        assert torch.equal(alone[0], y16[r]) and torch.equal(alone[0], y64[r])


@pytest.mark.parametrize("kn", W8_SHAPES)
def test_w8_linear_is_deterministic(cuda, w8_weights, kn):
    """(d) Two calls give the same bits (no atomics)."""
    from repro_torch.kernels import w8_linear
    w_q, w_s, _ = w8_weights[kn]
    for m in (16, 64):
        x = _w8_x(kn[0], m, 11)
        assert torch.equal(w8_linear.w8_linear_cuda(x, w_q, w_s),
                           w8_linear.w8_linear_cuda(x, w_q, w_s))


def test_w8_linear_raises_on_bad_input(cuda):
    """(e) A wrong dtype, device, scale shape or a non-contiguous input
    raises before anything launches."""
    from repro_torch.kernels import w8_linear
    gen = torch.Generator(device="cuda").manual_seed(1)
    w_q = torch.randint(-128, 128, (64, 32), generator=gen, device=cuda,
                        dtype=torch.int8)
    w_s = torch.full((1, 1), 0.01, device=cuda)
    x = torch.randn((4, 64), generator=gen, device=cuda).to(torch.bfloat16)
    bad = [(x.float(), w_q, w_s), (x, w_q.to(torch.int16), w_s),
           (x, w_q, w_s.double()), (x.cpu(), w_q, w_s), (x, w_q.cpu(), w_s),
           (x, w_q, w_s.cpu()), (x, w_q, w_s.reshape(1)),
           (x, w_q, torch.full((2, 1), 0.01, device=cuda)),
           (torch.randn((64, 4), device=cuda).to(torch.bfloat16).T, w_q, w_s),
           (x, torch.randint(-128, 128, (32, 64), device=cuda,
                             dtype=torch.int8).T, w_s),
           (x[:, :48].contiguous(), w_q, w_s),
           (torch.zeros((65, 64), device=cuda, dtype=torch.bfloat16), w_q,
            w_s)]
    before = w8_linear.launches
    for args in bad:
        with pytest.raises(ValueError):
            w8_linear.w8_linear_cuda(*args)
    assert w8_linear.launches == before


@pytest.fixture(scope="module")
def ds67b_int8():
    """DeepSeek-67B at full width, two layers, int8 serve weights in bf16
    (the f32 head and its int8 weight as served), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch("deepseek_67b").config.replace(n_layers=2,
                                                  serve_param_dtype="int8")
    return cfg, T.init_params(cfg, seed=0, device="cuda", serving=True)


def _ds67b_prefilled(cfg, params, b, plen, max_len, seed):
    """A paged cache of ``b`` slots, each prefilled with its own
    ``plen``-token prompt (the old path: more than 64 rows), and the
    prompts."""
    from repro_torch.models import transformer as T
    dev = params["lm_head"]["w_q"].device
    cache = T.make_paged_cache(cfg, b, max_len, block_k=32, device=dev)
    bps = cache["block_table"].shape[1]
    rows = torch.arange(1, 1 + b * bps, dtype=torch.int32,
                        device=dev).reshape(b, bps)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                           dtype=torch.int32).to(dev)
    for slot in range(b):
        T.prefill_paged(params, tokens[slot:slot + 1], cfg, cache,
                        torch.tensor([slot], dtype=torch.int32, device=dev),
                        rows[slot:slot + 1], calibrate=slot == 0)
    return cache, tokens


def test_w8_linear_serves_deepseek_67b_tokens_of_the_old_path(
        cuda, ds67b_int8, monkeypatch):
    """(f) DeepSeek-67B at full width, two layers, int8 weights in bf16.
    Served (80-token prompts, whose admissions keep the old path), the
    kernel runs seven times a layer a decode step.  Then sixteen decode
    steps of eight slots from one prefilled cache, three ways, each fed
    the greedy tokens of the third: through the kernel; through the
    dequant and cuBLAS (the old path, ``W8_ROWS`` 0); and the exact step,
    whose every bf16 linear is the f64 product of the same bf16 operands
    rounded once to bf16.  As in (b), the kernel's logits lie no further
    from the exact step's than twice the old path's do.  Both paths sum
    the same exact products in f32 in other orders, so a rounding of a
    linear's output may flip by one bf16 step either way, and the flips
    run on through the int8 cache and the layers; only an order much
    worse than cuBLAS's, or a wrong term, gives a larger error.  The error
    is the root mean square over the run's logits, which follows every
    slot's hidden state (a row's largest logit error follows one slot's
    flips alone).  Greedy tokens of the two paths can then differ only
    at near ties of the exact step; the count is printed."""
    from repro_torch.kernels import w8_linear
    from repro_torch.launch import serve as srv
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg, params = ds67b_int8
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 80, dtype=np.int32)
               for _ in range(6)]
    w8_linear.launches = 0
    served = srv.serve_paged(params, cfg, prompts, slots=4, gen=8,
                             gens=[int(g) for g in rng.integers(4, 9, 6)],
                             block_k=32)
    assert w8_linear.launches == served["decode_steps"] * cfg.n_layers * 7
    assert served["served"] == 6 and served["decode_steps"] > 0

    linear_apply = L.linear_apply

    def exact_linear(p, x, *, dtype=None):
        if "w_q" not in p or dtype != torch.bfloat16:
            return linear_apply(p, x, dtype=dtype)
        w = L.linear_weight(p, dtype).double()
        return (x.to(dtype).double() @ w).to(dtype)

    b, steps = 8, 16
    with torch.no_grad():
        exact, tokens = _ds67b_prefilled(cfg, params, b, 80, 80 + steps, 3)
        kernel = {k: v.clone() for k, v in exact.items()}
        old = {k: v.clone() for k, v in exact.items()}
        tok = tokens[:, -1].contiguous()
        sq_kernel = sq_old = 0.0
        same = 0
        for _ in range(steps):
            before = w8_linear.launches
            got, kernel = T.decode_step(params, tok, cfg, kernel)
            assert w8_linear.launches == before + 7 * cfg.n_layers
            with monkeypatch.context() as m:
                m.setattr(L, "W8_ROWS", 0)
                lib, old = T.decode_step(params, tok, cfg, old)
                m.setattr(L, "linear_apply", exact_linear)
                want, exact = T.decode_step(params, tok, cfg, exact)
            assert w8_linear.launches == before + 7 * cfg.n_layers
            sq_kernel += float(((got - want).double() ** 2).sum())
            sq_old += float(((lib - want).double() ** 2).sum())
            same += int((got.argmax(-1) == lib.argmax(-1)).sum())
            tok = want.argmax(-1).to(torch.int32)
    n = steps * b * want.shape[-1]
    rms_kernel, rms_old = (sq_kernel / n) ** 0.5, (sq_old / n) ** 0.5
    print(f"w8_linear (f): logits' rms error against the exact step "
          f"{rms_kernel:.4g} (cuBLAS {rms_old:.4g}); greedy tokens of the "
          f"two paths equal in {same} of {steps * b} decisions")
    assert 0 < rms_old and rms_kernel <= 2 * rms_old


def test_w8_linear_verify_logits_equal_the_decode_steps(cuda, ds67b_int8):
    """The speculative verify of int8 weights in bf16 keeps the weights
    that the decode step reads through the kernel int8
    (``layers.dequantized`` with the rows), and runs each token's (B, 1)
    slice through the kernel at the decode step's B rows: its logits for T
    tokens equal T ``decode_step`` calls' bit for bit, so speculative
    tokens equal plain ones."""
    from repro_torch.kernels import w8_linear
    from repro_torch.models import transformer as T

    cfg, params = ds67b_int8
    b, t = 4, 4
    with torch.no_grad():
        cache, _ = _ds67b_prefilled(cfg, params, b, 16, 16 + t, 7)
        gen = torch.Generator(device="cpu").manual_seed(8)
        tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                               dtype=torch.int32).to(cuda)
        seq = {k: v.clone() for k, v in cache.items()}
        before = w8_linear.launches
        logits, _ = T.verify_step(params, tokens, cfg, cache)
        assert w8_linear.launches == before + t * 7 * cfg.n_layers
        for i in range(t):
            step, seq = T.decode_step(params, tokens[:, i].contiguous(), cfg,
                                      seq)
            assert torch.equal(logits[:, i], step)
        assert w8_linear.launches == before + 2 * t * 7 * cfg.n_layers
