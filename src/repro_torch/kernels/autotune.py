"""Tile lookups for the split-softmax decode and verify kernels (port of
``repro/kernels/autotune.py``'s tables).

The reference's Pallas decode kernels take their k-tile ``block_k`` and
the sublane floor ``g_pad_min`` of their ``(g_pad, D)`` accumulator as
parameters; every choice is bit-identical, so the choice is a pure perf
knob.  This module keeps the reference's static heuristic table and its
lookups, :func:`candidate_block_ks`, :func:`heuristic_block_k`,
:func:`decode_tile` and :func:`verify_tile`, with the same answers.

The port's CUDA kernels fix their tiles at compile time (a 32-key tile a
cluster rank; the GQA group in the rows of an ``mma.sync`` tile), and
``kernels/ops.py`` takes no ``block_k``.  So nothing in the port consults
these lookups yet, and the reference's sweep (``sweep_decode_tiles``,
``sweep_verify_tiles`` and its CLI, which time each candidate and cache
the winner) has no counterpart until a kernel takes its tile as a
parameter; the lookups therefore never see a swept winner, as the
reference's do not before a sweep.

:func:`kernels_supported` is the port's counterpart of the reference's
``pallas_supported``: whether the compiled kernels can run here, i.e. a
card is present and every CUDA kernel of ``cuda_build.KERNELS`` is built.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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


def kernels_supported() -> bool:
    """True when the compiled CUDA kernels can run here: a card is present
    and each kernel's library is built from the current sources."""
    import torch
    from repro_torch.kernels import cuda_build
    return torch.cuda.is_available() and all(
        cuda_build.library_path(name).exists()
        for name in cuda_build.KERNELS)


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
    tokens."""
    return heuristic_block_k(head_dim, s_max), 8


def verify_tile(head_dim: int, s_max: int, gamma: int) -> Tuple[int, int]:
    """(block_k, g_pad_min) for a gamma-token speculative verify: the
    verify accumulator is ``gamma`` times the decode kernel's, so past
    gamma 4 the heuristic steps down one block-size notch."""
    bk = heuristic_block_k(head_dim, s_max)
    if gamma > 4:
        smaller = [c for c in candidate_block_ks(s_max) if c < bk]
        if smaller:
            bk = max(smaller)
    return bk, 8
