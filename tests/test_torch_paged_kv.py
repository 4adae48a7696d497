"""Speculative pool operations of the port against ``repro.core.paged_kv``.

``append_kv``, ``rollback_slot``, ``tail_blocks``, ``truncate_lengths`` and
``PoolManager.reclaim_tail`` get the same numpy inputs in both packages and
must give equal pools, tables, lengths and block lists.  The port updates
the pool tensors in place, where the reference returns new arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paged_kv as jpaged
from repro.launch.engines import base as jbase
from repro_torch.core import paged_kv as tpaged
from repro_torch.launch.engines import base as tbase

NB, H, BK, D, B, MB = 10, 2, 4, 8, 3, 3


def _table(rng):
    return rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB).astype(
        np.int32)


@pytest.mark.parametrize("t", [1, 3, 5])
def test_append_kv_matches_reference_in_place(rng, t):
    pages = rng.integers(-128, 128, (2, NB, H, BK, D)).astype(np.int8)
    table = _table(rng)
    # slot 0 from empty, slot 1 across a block boundary, slot 2 over-runs its
    # row: its positions past the end clamp onto the last addressed cell
    base = np.array([0, BK - 1, MB * BK - 2], np.int32)
    vals = rng.integers(-128, 128, (B, t, H, D)).astype(np.int8)
    vals[2, 1:] = vals[2, -1]        # clamped writes agree in any order
    want = jpaged.append_kv(jnp.asarray(pages[1]), jnp.asarray(table),
                            jnp.asarray(base), jnp.asarray(vals))
    stacked = torch.from_numpy(pages.copy())
    layer = stacked[1]               # a layer's view, as the model passes it
    out = tpaged.append_kv(layer, torch.from_numpy(table),
                           torch.from_numpy(base), torch.from_numpy(vals))
    assert out is layer
    np.testing.assert_array_equal(stacked[1].numpy(), np.asarray(want))
    np.testing.assert_array_equal(stacked[0].numpy(), pages[0])


@pytest.mark.parametrize("new_len", [0, 1, BK, BK + 1, MB * BK])
def test_rollback_slot_matches_reference(rng, new_len):
    table = _table(rng)
    lens = np.array([9, 11, 12], np.int32)
    jpool = dict(jpaged.init_kv_pages(1, NB, H, BK, D, B, MB),
                 block_table=jnp.asarray(table), length=jnp.asarray(lens))
    tpool = tpaged.init_kv_pages(1, NB, H, BK, D, B, MB, device="cpu")
    tpool["block_table"].copy_(torch.from_numpy(table))
    tpool["length"].copy_(torch.from_numpy(lens))
    table_before = tpool["block_table"]
    want = jpaged.rollback_slot(jpool, 1, new_len)
    tpaged.rollback_slot(tpool, 1, new_len)
    assert tpool["block_table"] is table_before
    np.testing.assert_array_equal(tpool["block_table"].numpy(),
                                  np.asarray(want["block_table"]))
    np.testing.assert_array_equal(tpool["length"].numpy(),
                                  np.asarray(want["length"]))


def test_tail_blocks_and_truncate_lengths_match_reference(rng):
    ids = [7, 3, tpaged.TRASH_BLOCK, 5]
    for new_len in range(0, 5 * BK):
        assert tpaged.tail_blocks(ids, new_len, BK) == \
            jpaged.tail_blocks(ids, new_len, BK)
    jpool = jpaged.init_kv_pages(1, NB, H, BK, D, B, MB)
    tpool = tpaged.init_kv_pages(1, NB, H, BK, D, B, MB, device="cpu")
    new = np.array([5, 0, 12], np.int32)
    lengths = tpool["length"]
    tpaged.truncate_lengths(tpool, torch.from_numpy(new))
    assert tpool["length"] is lengths
    np.testing.assert_array_equal(
        tpool["length"].numpy(),
        np.asarray(jpaged.truncate_lengths(jpool, jnp.asarray(new))["length"]))


def test_reclaim_tail_matches_reference():
    pagers = [mod.PoolManager(alloc_mod.BlockAllocator(NB), MB + 2, BK)
              for mod, alloc_mod in ((jbase, jpaged), (tbase, tpaged))]
    for pm in pagers:
        pm.admit_row(0, 2 * BK + 1)              # 3 blocks
        pm.admit_row(1, BK)                      # 1 block
        pm.grow(1, 2)
    for keep in (2 * BK + 1, 2 * BK, 1, 0):
        got = [pm.reclaim_tail(0, keep) for pm in pagers]
        assert got[0] == got[1]
        assert pagers[0].owned == pagers[1].owned
        assert pagers[0].alloc.free_count == pagers[1].alloc.free_count
    assert pagers[1].owned[0] == [] and pagers[1].alloc.live_count == 3
