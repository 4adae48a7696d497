"""The port's tile sweep (``repro_torch.kernels.autotune``'s sweep cache,
sweeps and CLI) against the reference's (``repro.kernels.autotune``), and
the tile lookups reaching the kernels' wrappers through ``kernels/ops.py``.

On the CPU the sweep times the plain versions (``exact=True``, their exact
sums cut into ``block_k`` chunks) at every candidate, as the reference
times its interpreter; the bits are the same at every ``block_k``.  The
instances themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, marked ``gpu``).
"""
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.core.lut import LUTConfig, build_exp_lut, build_recip_lut
from repro_torch.core import quantization as qlib
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops
from repro_torch.kernels import splitmax_decode as K

CFG = LUTConfig(scale_z=8.0 / 127)


@pytest.fixture(autouse=True)
def empty_sweep_caches():
    at.clear_sweep_cache()
    jat.clear_sweep_cache()
    yield
    at.clear_sweep_cache()
    jat.clear_sweep_cache()


def _luts():
    return (torch.from_numpy(build_exp_lut(CFG)),
            torch.from_numpy(build_recip_lut(CFG)))


# the reference's hypothesis ranges (head_dim 1..512, s_max 1..8192), at
# fixed points: odd dims, primes, powers of two and the serving caches
VALID_SHAPES = [(1, 1), (3, 1000), (16, 7), (33, 8191), (64, 290),
                (64, 2048), (80, 512), (100, 4096), (128, 8192),
                (192, 1), (256, 96), (512, 5000)]


@pytest.mark.parametrize("head_dim,s_max", VALID_SHAPES)
def test_autotune_tiles_always_valid(head_dim, s_max):
    bk, g_pad = at.decode_tile(head_dim, s_max)
    assert s_max % bk == 0, (head_dim, s_max, bk)
    assert bk <= s_max
    assert g_pad >= 8
    # and the port's kernels have an instance for it (or the default one)
    stage, row_pad = K.tile_instance(bk, g_pad, s_max)
    assert stage in (0,) + K.TILE_STAGES and row_pad in (16, 32)


def test_autotune_sweep_caches_winner():
    timings = at.sweep_decode_tiles(32, 64, b=1, hq=2, hkv=1, iters=1)
    assert timings, "sweep returned no candidates"
    winner = min(timings, key=timings.get)
    assert at.decode_tile(32, 64) == winner
    # a different shape still falls back to the heuristic
    assert at.decode_tile(32, 128) == (at.heuristic_block_k(32, 128), 8)
    at.clear_sweep_cache()
    assert at.decode_tile(32, 64) == (at.heuristic_block_k(32, 64), 8)


def test_autotune_verify_sweep_caches_winner():
    timings = at.sweep_verify_tiles(32, 64, 4, b=1, hq=2, hkv=1, iters=1)
    winner = min(timings, key=timings.get)
    assert at.verify_tile(32, 64, 4) == winner
    # another gamma, and the decode, still take the heuristic
    assert at.verify_tile(32, 64, 8) == jat.verify_tile(32, 64, 8)
    assert at.decode_tile(32, 64) == (at.heuristic_block_k(32, 64), 8)


@pytest.mark.parametrize("gamma", [None, 2])
def test_sweep_enumerates_the_references_candidates(gamma):
    """The same (block_k, g_pad_min) keys as the reference's sweep on the
    same small shape (its interpreter against the port's plain version),
    and each winner cached under the same key."""
    kw = dict(b=1, hq=2, hkv=1, iters=1)
    if gamma is None:
        want = jat.sweep_decode_tiles(32, 64, **kw)
        got = at.sweep_decode_tiles(32, 64, **kw)
        keys = ("decode", 32, 64)
    else:
        want = jat.sweep_verify_tiles(32, 64, gamma, **kw)
        got = at.sweep_verify_tiles(32, 64, gamma, **kw)
        keys = ("verify", 32, 64, gamma)
    assert sorted(got) == sorted(want)
    assert all(np.isfinite(t) and t > 0 for t in got.values())
    assert set(at._SWEEP_CACHE) == {keys + (False,)}
    assert set(jat._SWEEP_CACHE) == {keys + (False,)}


def _dense(rng, b, hq, hkv, s_max, d, gamma=None):
    q = torch.from_numpy(rng.normal(0, 0.5, (b, hq, d) if gamma is None
                                    else (b, hq, gamma, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.integers(-128, 128, (b, hkv, s_max, d)
                                          ).astype(np.int8)) for _ in range(2))
    per = (b,) if gamma is None else (b, gamma)
    s_q = torch.from_numpy(rng.uniform(0.005, 0.02, per).astype(np.float32))
    m_z = ops.requant_multiplier(s_q, torch.tensor(0.012), d, CFG)
    return q, k, v, m_z, s_q, torch.tensor(0.02)


@pytest.mark.parametrize("s_max", [290, 512])
@pytest.mark.parametrize("window", [None, 48])
def test_plain_versions_are_bit_identical_at_every_block_k(rng, s_max,
                                                           window):
    """The plain dense decode (fused and composed) and verify with
    ``exact=True`` give the same bits at every candidate ``block_k`` and
    unchunked: the chunks' sums are exact integers."""
    lens = torch.tensor([0, 1, 33, s_max // 2, s_max - 1, s_max],
                        dtype=torch.int32)
    luts = _luts()
    q, k, v, m_z, s_q, s_v = _dense(rng, len(lens), 8, 2, s_max, 32)
    q_q = qlib.quantize(q, s_q[:, None, None])
    qv, _, _, m_zv, s_qv, _ = _dense(rng, len(lens), 8, 2, s_max, 32, 4)
    lens_v = torch.clamp_min(lens, 4)
    kw = dict(cfg=CFG, window=window, exact=True)
    want = (K.splitmax_decode_fused_plain(q, k, v, m_z, s_q, s_v, lens, *luts,
                                          **kw),
            K.splitmax_decode_plain(q_q, k, v, m_z, s_v, lens, *luts, **kw),
            K.splitmax_decode_fused_verify_plain(qv, k, v, m_zv, s_qv, s_v,
                                                 lens_v, *luts, **kw))
    for bk in at.CANDIDATE_BLOCK_K + (s_max,):
        got = (K.splitmax_decode_fused_plain(q, k, v, m_z, s_q, s_v, lens,
                                             *luts, block_k=bk, **kw),
               K.splitmax_decode_plain(q_q, k, v, m_z, s_v, lens, *luts,
                                       block_k=bk, **kw),
               K.splitmax_decode_fused_verify_plain(
                   qv, k, v, m_zv, s_qv, s_v, lens_v, *luts, block_k=bk,
                   **kw))
        for g, w in zip(got, want):
            assert torch.equal(g, w), bk


def _record(monkeypatch, name):
    seen = []
    fn = getattr(K, name)

    def rec(*args, **kw):
        seen.append((kw.get("block_k"), kw.get("g_pad_min")))
        return fn(*args, **kw)
    monkeypatch.setattr(K, name, rec)
    return seen


def test_ops_dense_decode_and_verify_pass_the_looked_up_tile(rng,
                                                             monkeypatch):
    """A swept winner put in the cache reaches the wrappers that
    ``kernels/ops.py`` calls (on the CPU, the plain versions); without one,
    and with ``exact_recip``, no tile: the default instance, the kernel
    as it was before tiles were parameters."""
    s_max, d, gamma = 512, 32, 4
    q, k, v, _, s_q, s_v = _dense(rng, 3, 8, 2, s_max, d)
    qv = _dense(rng, 3, 8, 2, s_max, d, gamma)[0]
    lens = torch.tensor([5, 100, 512], dtype=torch.int32)
    s_k = torch.tensor(0.012)
    luts = _luts()
    fused = _record(monkeypatch, "splitmax_decode_fused_plain")
    comp = _record(monkeypatch, "splitmax_decode_plain")
    ver = _record(monkeypatch, "splitmax_decode_fused_verify_plain")

    def run(**kw):
        """Each op's tile, as its wrapper was called by ``ops`` (the
        first call recorded: a plain version calls the others)."""
        got = []
        for seen, op in (
                (fused, lambda: ops.splitmax_decode_fused(
                    q, k, v, s_q, s_k, s_v, lens, *luts, cfg=CFG, **kw)),
                (comp, lambda: ops.splitmax_decode(
                    qlib.quantize(q, s_q[:, None, None]), k, v, s_q, s_k,
                    s_v, lens, *luts, cfg=CFG, **kw)),
                (ver, lambda: ops.splitmax_decode_fused_verify(
                    qv, k, v, torch.tensor(0.01), s_k, s_v, lens, *luts,
                    cfg=CFG, **kw))):
            for lst in (fused, comp, ver):
                lst.clear()
            op()
            got.append(seen[0])
        return got
    assert at.decode_tile(d, s_max) == (at.heuristic_block_k(d, s_max), 8)
    assert run() == [(None, 8)] * 3
    at._SWEEP_CACHE[("decode", d, s_max, at.kernels_supported())] = (64, 16)
    at._SWEEP_CACHE[("verify", d, s_max, gamma,
                     at.kernels_supported())] = (256, 16)
    assert run() == [(64, 16), (64, 16), (256, 16)]
    assert run(exact_recip=True) == [(None, 8)] * 3
    assert run(block_k=128) == [(128, 8)] * 3


def test_ops_paged_verify_takes_verify_tiles_g_pad(rng, monkeypatch):
    """The paged verify asks ``verify_tile`` at the table's positions
    (pool block_k x table width) for its ``g_pad_min``, as the
    reference's ``ops.py`` does; the paged decode asks nothing."""
    from repro_torch.core import paged_kv
    b, hq, hkv, d, bk, mb, gamma = 2, 8, 2, 32, 32, 4, 4
    nb = 1 + b * mb
    kp, vp = (torch.from_numpy(rng.integers(-128, 128, (nb, hkv, bk, d)
                                            ).astype(np.int8))
              for _ in range(2))
    table = torch.arange(1, nb, dtype=torch.int32).reshape(b, mb)
    lens = torch.tensor([40, 128], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(b, hq, gamma, d)).astype(
        np.float32))
    seen = _record(monkeypatch, "splitmax_decode_fused_verify_paged_plain")
    args = (q, kp, vp, table, torch.tensor(0.01), torch.tensor(0.012),
            torch.tensor(0.02),
            lens, *_luts())
    ops.splitmax_decode_fused_verify_paged(*args, cfg=CFG)
    assert seen[-1] == (None, 8)
    at._SWEEP_CACHE[("verify", d, bk * mb, gamma,
                     at.kernels_supported())] = (64, 16)
    got = ops.splitmax_decode_fused_verify_paged(*args, cfg=CFG)
    assert seen[-1] == (None, 16)
    assert paged_kv.TRASH_BLOCK == 0 and got.shape == q.shape


def test_cli_runs_on_the_cpu_and_prints_a_winner(capsys):
    timings, winner = at.main(["--head-dim", "32", "--seq-len", "64",
                               "--batch", "1", "--iters", "1"])
    out = capsys.readouterr().out
    assert "sweeping decode tiles: head_dim=32 s_max=64 (plain)" in out
    assert f"winner: block_k={winner[0]} g_pad_min={winner[1]}" in out
    assert at.decode_tile(32, 64) == winner == min(timings, key=timings.get)
    assert out.count("(plain)") == len(timings) + 1
    _, winner = at.main(["--head-dim", "32", "--seq-len", "64", "--batch",
                         "1", "--iters", "1", "--gamma", "2"])
    out = capsys.readouterr().out
    assert "sweeping verify(gamma=2) tiles" in out
    assert at.verify_tile(32, 64, 2) == winner


def test_tile_instances_and_refusals():
    """The mapping of the reference's tile to an instance, and the sweep's
    refusals: a layout past 227 KB of shared memory, or a tile with no
    instance, each with its reason."""
    assert [K.tile_instance(bk, 8, 2048)[0] for bk in at.CANDIDATE_BLOCK_K] \
        == list(K.TILE_STAGES)
    assert K.tile_instance(128, 16, 2048) == (4, 32)
    assert K.tile_instance(290, 8, 290) == (0, 16)      # the default
    assert K.tile_instance(None, 8, 64) == (0, 16)
    for bad in ((48, 8, 96), (290, 8, 580), (64, 4, 64)):
        with pytest.raises(ValueError, match="no compiled instance"):
            K.tile_instance(*bad)
    assert K.tile_refusal("decode", 128, 8, group=8, d=64, s_max=2048,
                          cfg=CFG) is None
    why = K.tile_refusal("decode", 512, 8, group=8, d=256, s_max=2048,
                         cfg=CFG)
    assert why is not None and "> 227 KB" in why
    why = K.tile_refusal("verify", 512, 16, group=8, d=128, s_max=2048,
                         cfg=CFG, tokens=8)
    assert why is not None and "> 227 KB" in why
    assert "no compiled dense verify" in K.tile_refusal(
        "verify", 290, 16, group=8, d=64, s_max=290, cfg=CFG, tokens=4)
    # the sweep reports a refused candidate as inf and never picks it
    timings = at.sweep_decode_tiles(256, 512, b=1, hq=8, hkv=1, iters=1)
    assert np.isinf(timings[(512, 8)]) and np.isinf(timings[(512, 16)])
    assert at.decode_tile(256, 512)[0] != 512


def test_cuda_tile_wrappers_refuse_cpu_and_bad_tiles(rng):
    q, k, v, m_z, s_q, s_v = _dense(rng, 2, 8, 2, 64, 32)
    lens = torch.tensor([3, 64], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.splitmax_decode_fused_cuda(q, k, v, m_z, s_q, s_v, lens, *_luts(),
                                     cfg=CFG, block_k=64)
    with pytest.raises(ValueError, match="exact_recip"):
        K._instance("decode", 64, 8, 64, True)
