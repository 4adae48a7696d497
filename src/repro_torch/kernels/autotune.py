"""Tile selection for the split-softmax decode and verify kernels (port of
``repro/kernels/autotune.py``).

The reference's Pallas decode kernels take their k-tile ``block_k`` and
the sublane floor ``g_pad_min`` of their ``(g_pad, D)`` accumulator as
parameters; every choice is bit-identical, so the choice is a pure perf
knob.  This module keeps the reference's static heuristic table and its
lookups (:func:`candidate_block_ks`, :func:`heuristic_block_k`,
:func:`decode_tile`, :func:`verify_tile`, with the same answers), its
sweep cache and its sweeps, which time every candidate on synthetic
inputs and cache the winner process-wide, so that ``kernels/ops.py``
picks it up on the next dispatch.

The port's counterpart of ``(block_k, g_pad_min)`` (``kernels/
splitmax_decode.tile_instance``):

  * ``block_k`` is the keys a cluster rank streams a round: ``block_k /
    32`` tiles of 32 keys held in flight at once (a compile-time ``kStage``
    of the dense decode, ``csrc/splitmax_decode.cu``, and of the dense
    verify, ``csrc/splitmax_verify_tiles.cuh``), so 32, 64, 128, 256 and 512
    are stages 1, 2, 4, 8 and 16;
  * ``g_pad_min`` pads the verify's query rows (T x group of a KV head, in
    ``mma.sync`` m16 row tiles) to a multiple of ``2 * g_pad_min``: 16 (one
    m16 tile, the default) or 32.  The paged verify takes only this half of
    the tile (its keys come in the pool's ``block_k``).  The decode kernel
    holds its group's rows on CUDA cores and pads none: ``g_pad_min``
    picks nothing there, and both candidates of a ``block_k`` time the
    same instance, as the reference sweeps both;
  * the default instance is the kernel as it was before tiles were
    parameters, its stage (up to 4 tiles) sized by a shared-memory
    budget.  ``kernels/ops.py`` launches it for the heuristic's answer
    (nothing swept for the shape: :func:`swept`), so an empty sweep cache
    serves what was served before; and the wrappers launch it for
    ``block_k == s_max``, the reference's one tile over a cache that no
    candidate divides (the port's last tile is ragged, so such an
    ``s_max`` needs no tile of its own).

A candidate whose instance cannot hold its layout in the 227 KB of shared
memory a block may use at that head dim is refused by the sweep, with the
reason, and never replaced by another tile.  A tile with no compiled
instance raises in the kernel's wrapper.

:func:`kernels_supported` is the port's counterpart of the reference's
``pallas_supported``: whether the compiled kernels can run here, i.e. a
card is present and every CUDA kernel of ``cuda_build.KERNELS`` is built.
On the card the sweep times each compiled instance with CUDA events around
a CUDA graph's replay, after a warm-up; elsewhere it times the plain version (``exact=True``, its exact
sums cut into ``block_k`` chunks) at each candidate, as the reference times
its interpreter, so that the machinery runs in CI.

``python -m repro_torch.kernels.autotune --head-dim 64 --seq-len 2048``
re-sweeps one shape (``--gamma 4``: the verify) and prints the table and
the winner; on a machine with a card it builds the kernels first.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

# k-tile candidates, largest-first VMEM-safe set shared by dense and paged.
CANDIDATE_BLOCK_K = (32, 64, 128, 256, 512)
# sublane floor of the reference's (g_pad, D) accumulator
CANDIDATE_G_PAD = (8, 16)

# head_dim -> ((seq_len ceiling, block_k), ...); None = no ceiling: the
# reference's table, derived from its VMEM budget (K/V tiles of
# 2 * block_k * D int8 bytes plus the f32 accumulator)
_HEURISTIC_TABLE: Dict[int, Tuple[Tuple[Optional[int], int], ...]] = {
    32: ((256, 64), (2048, 128), (None, 256)),
    64: ((256, 64), (2048, 128), (None, 256)),
    128: ((512, 64), (None, 128)),
    256: ((None, 64),),
}

# (kind, head_dim, s_max[, gamma], compiled?) -> (block_k, g_pad_min);
# filled by sweeps
_SWEEP_CACHE: Dict[Tuple, Tuple[int, int]] = {}

_SUPPORTED: List[bool] = []     # True once the kernels were seen built


def kernels_supported() -> bool:
    """True when the compiled CUDA kernels can run here: a card is present
    and each kernel's library is built from the current sources (the
    libraries stay once built, so a True is kept)."""
    if _SUPPORTED:
        return True
    import torch
    from repro_torch.kernels import cuda_build
    ok = torch.cuda.is_available() and all(
        cuda_build.library_path(name).exists()
        for name in cuda_build.KERNELS)
    if ok:
        _SUPPORTED.append(True)
    return ok


def candidate_block_ks(s_max: int) -> List[int]:
    """Candidates that tile ``s_max`` exactly (the reference's kernels
    assert this)."""
    cands = [c for c in CANDIDATE_BLOCK_K if c <= s_max and s_max % c == 0]
    return cands or [s_max]


def heuristic_block_k(head_dim: int, s_max: int) -> int:
    """Table lookup, snapped to a divisor of ``s_max``."""
    key = min((d for d in _HEURISTIC_TABLE if d >= head_dim),
              default=max(_HEURISTIC_TABLE))
    want = next(bk for ceil, bk in _HEURISTIC_TABLE[key]
                if ceil is None or s_max <= ceil)
    valid = candidate_block_ks(s_max)
    return min(valid, key=lambda c: (abs(c - want), c))


def decode_tile(head_dim: int, s_max: int) -> Tuple[int, int]:
    """(block_k, g_pad_min) for a dense decode of ``s_max`` cached
    tokens.  Swept winners (exact shape match) beat the heuristic table."""
    key = ("decode", head_dim, s_max, kernels_supported())
    if key in _SWEEP_CACHE:
        return _SWEEP_CACHE[key]
    return heuristic_block_k(head_dim, s_max), 8


def verify_tile(head_dim: int, s_max: int, gamma: int) -> Tuple[int, int]:
    """(block_k, g_pad_min) for a gamma-token speculative verify: the
    verify accumulator is ``gamma`` times the decode kernel's, so past
    gamma 4 the heuristic steps down one block-size notch.  Swept winners
    (exact (shape, gamma) match) win."""
    key = ("verify", head_dim, s_max, gamma, kernels_supported())
    if key in _SWEEP_CACHE:
        return _SWEEP_CACHE[key]
    bk = heuristic_block_k(head_dim, s_max)
    if gamma > 4:
        smaller = [c for c in candidate_block_ks(s_max) if c < bk]
        if smaller:
            bk = max(smaller)
    return bk, 8


def swept(kind: str, head_dim: int, s_max: int, *gamma: int) -> bool:
    """Whether a sweep cached a winner for this shape here (the key of
    :func:`decode_tile`, or with ``gamma`` of :func:`verify_tile`).
    ``kernels/ops.py`` launches a swept winner's instance, and for the
    heuristic's answer the default instance."""
    return (kind, head_dim, s_max, *gamma, kernels_supported()) in _SWEEP_CACHE


def clear_sweep_cache() -> None:
    _SWEEP_CACHE.clear()


def _time_call(fn, *args, iters: int) -> float:
    """Seconds of one call of ``fn(*args)``, the least of ``iters`` samples
    after a warm-up call.  On the card a sample is CUDA events around the
    replay of a CUDA graph of ``BURST`` calls (the device's time, without
    the host's dispatch); elsewhere the host's clock around one call."""
    import torch
    out = fn(*args)
    if not (isinstance(out, torch.Tensor) and out.is_cuda):
        best = math.inf
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(BURST):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(iters):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / BURST)
    return best


BURST = 20                      # calls a replayed graph holds on the card


def _inputs(head_dim: int, s_max: int, gamma: Optional[int], b: int, hq: int,
            hkv: int, seed: int, device: str):
    """The reference's synthetic sweep inputs: q ~ N(0, 0.5) in f32, int8
    K/V uniform in [-128, 128), every slot at ``s_max``; ``m_z`` 1e-4,
    ``s_q`` 0.01 and ``s_v`` 0.02, per slot (and token) as the port's
    kernels take them."""
    import torch
    from repro_torch.core import split_softmax as ss
    from repro_torch.core.lut import LUTConfig
    cfg = LUTConfig(scale_z=2.6 / 127)
    exp_lut, recip_lut = ss.make_luts(cfg, device)
    rng = np.random.default_rng(seed)
    qshape = (b, hq, head_dim) if gamma is None else (b, hq, gamma, head_dim)
    q = torch.tensor(rng.normal(0, 0.5, qshape), dtype=torch.float32,
                     device=device)
    k, v = (torch.tensor(rng.integers(-128, 128, (b, hkv, s_max, head_dim)),
                         dtype=torch.int8, device=device) for _ in range(2))
    lens = torch.full((b,), s_max, dtype=torch.int32, device=device)
    per = (b,) if gamma is None else (b, gamma)
    m_z = torch.full(per, 1e-4, dtype=torch.float32, device=device)
    s_q = torch.full(per, 0.01, dtype=torch.float32, device=device)
    s_v = torch.tensor(0.02, dtype=torch.float32, device=device)
    return cfg, (q, k, v, m_z, s_q, s_v, lens, exp_lut, recip_lut)


def _compiled() -> bool:
    """The sweep's gate: with a card, build the kernels first."""
    import torch
    if torch.cuda.is_available():
        from repro_torch.kernels import cuda_build
        cuda_build.build()
    return kernels_supported()


def _sweep(kind: str, head_dim: int, s_max: int, gamma: Optional[int], *,
           b: int, hq: int, hkv: int, iters: int, seed: int,
           g_pads: Tuple[int, ...], verbose: bool
           ) -> Tuple[Dict[Tuple[int, int], float], bool]:
    from repro_torch.kernels import splitmax_decode as K
    compiled = _compiled()
    cfg, args = _inputs(head_dim, s_max, gamma, b, hq, hkv, seed,
                        "cuda" if compiled else "cpu")
    if kind == "decode":
        fn = (K.splitmax_decode_fused_cuda if compiled
              else K.splitmax_decode_fused_plain)
    else:
        fn = (K.splitmax_decode_fused_verify_cuda if compiled
              else K.splitmax_decode_fused_verify_plain)
    extra = {} if compiled else {"exact": True}
    timings: Dict[Tuple[int, int], float] = {}
    for block_k in candidate_block_ks(s_max):
        for g_pad in g_pads:
            why = K.tile_refusal(kind, block_k, g_pad, group=hq // hkv,
                                 d=head_dim, s_max=s_max, cfg=cfg,
                                 tokens=gamma or 1)
            if why is not None:
                timings[(block_k, g_pad)] = math.inf
                if verbose:
                    print(f"  block_k={block_k:4d} g_pad={g_pad:2d}  "
                          f"refused: {why}")
                continue

            def run(*a, _bk=block_k, _gp=g_pad):
                return fn(*a, cfg=cfg, block_k=_bk, g_pad_min=_gp, **extra)
            timings[(block_k, g_pad)] = _time_call(run, *args, iters=iters)
            if verbose:
                print(f"  block_k={block_k:4d} g_pad={g_pad:2d}  "
                      f"{timings[(block_k, g_pad)] * 1e6:9.1f} us"
                      f"  ({'cuda' if compiled else 'plain'})")
    if not any(math.isfinite(t) for t in timings.values()):
        raise RuntimeError(f"{kind} sweep at head_dim {head_dim}, s_max "
                           f"{s_max}: every candidate was refused")
    return timings, compiled


def sweep_decode_tiles(head_dim: int, s_max: int, *, b: int = 4, hq: int = 4,
                       hkv: int = 2, iters: int = 3, seed: int = 0,
                       g_pads: Tuple[int, ...] = CANDIDATE_G_PAD,
                       verbose: bool = False) -> Dict[Tuple[int, int], float]:
    """Benchmark every (block_k, g_pad_min) candidate for one decode shape.

    Times the *fused* dense decode: its compiled instances when
    :func:`kernels_supported` (after building them where a card is
    present), the plain version otherwise; the gate, not the caller,
    decides.  A refused candidate's time is ``inf``.  Caches the winner for
    :func:`decode_tile` and returns the full ``{(block_k, g_pad_min):
    seconds}`` timing table."""
    timings, compiled = _sweep("decode", head_dim, s_max, None, b=b, hq=hq,
                               hkv=hkv, iters=iters, seed=seed,
                               g_pads=g_pads, verbose=verbose)
    winner = min(timings, key=timings.get)
    _SWEEP_CACHE[("decode", head_dim, s_max, compiled)] = winner
    return timings


def sweep_verify_tiles(head_dim: int, s_max: int, gamma: int, *, b: int = 4,
                       hq: int = 4, hkv: int = 2, iters: int = 3,
                       seed: int = 0,
                       g_pads: Tuple[int, ...] = CANDIDATE_G_PAD,
                       verbose: bool = False
                       ) -> Dict[Tuple[int, int], float]:
    """Benchmark (block_k, g_pad_min) candidates for one verify shape.

    Same protocol as :func:`sweep_decode_tiles` but against the
    gamma-query dense verify; winners land under a gamma-keyed cache entry
    so :func:`verify_tile` picks them up on the next dispatch."""
    timings, compiled = _sweep("verify", head_dim, s_max, gamma, b=b, hq=hq,
                               hkv=hkv, iters=iters, seed=seed,
                               g_pads=g_pads, verbose=verbose)
    winner = min(timings, key=timings.get)
    _SWEEP_CACHE[("verify", head_dim, s_max, gamma, compiled)] = winner
    return timings


def main(argv=None) -> Tuple[Dict[Tuple[int, int], float], Tuple[int, int]]:
    """The CLI: sweep one shape, print the table and the winner; returns
    both."""
    import argparse
    ap = argparse.ArgumentParser(
        description="re-sweep decode/verify tile sizes for one shape")
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--gamma", type=int, default=0,
                    help="sweep the gamma-token verify kernel instead of "
                         "the one-token decode kernel")
    args = ap.parse_args(argv)
    kind = f"verify(gamma={args.gamma})" if args.gamma else "decode"
    print(f"sweeping {kind} tiles: head_dim={args.head_dim} "
          f"s_max={args.seq_len} "
          f"({'compiled cuda' if _compiled() else 'plain'})")
    if args.gamma:
        timings = sweep_verify_tiles(args.head_dim, args.seq_len, args.gamma,
                                     b=args.batch, iters=args.iters,
                                     verbose=True)
        bk, gp = verify_tile(args.head_dim, args.seq_len, args.gamma)
    else:
        timings = sweep_decode_tiles(args.head_dim, args.seq_len,
                                     b=args.batch, iters=args.iters,
                                     verbose=True)
        bk, gp = decode_tile(args.head_dim, args.seq_len)
    print(f"winner: block_k={bk} g_pad_min={gp}")
    return timings, (bk, gp)


if __name__ == "__main__":
    main()
