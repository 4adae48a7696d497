"""Pool operations of the port against ``repro.core.paged_kv``.

``append_kv``, ``rollback_slot``, ``tail_blocks``, ``truncate_lengths`` and
``PoolManager.reclaim_tail`` get the same numpy inputs in both packages and
must give equal pools, tables, lengths and block lists.  The port updates
the pool tensors in place, where the reference returns new arrays.

The allocator's invariants (``tests/test_paged_kv.py``: FIFO recycling,
double, reserved and foreign frees, all-or-nothing exhaustion; and
``tests/test_engines.py``'s carve: FIFO carved ids off the free list, not
live, never freed) run the same call sequence on both packages' allocators
and compare every result, every raised error and the counts after each
call.  ``gather_kv`` and ``write_blocks`` are held to the reference's
addressing and prefill write.
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


# ------------------------------ allocator -----------------------------------

def _run_both(num_blocks, calls):
    """``calls`` -- (method, argument) pairs -- on a fresh allocator of each
    package: per call the result (or the error's class), then the free,
    live, carved and high-water counts.  The two lists must be equal."""
    logs = []
    for mod in (jpaged, tpaged):
        a = mod.BlockAllocator(num_blocks)
        log = []
        for method, arg in calls:
            try:
                out = getattr(a, method)(arg)
            except mod.BlockAllocationError as e:
                out = ("BlockAllocationError", str(e).split(" ")[0:2])
            log.append((method, out, a.free_count, a.live_count,
                        a.carved_count, a.high_water))
        logs.append(log)
    assert logs[1] == logs[0]
    return logs[1]


def test_allocator_alloc_free_recycle_matches_reference():
    log = _run_both(8, [("alloc", 3), ("free", [1, 2, 3]), ("alloc", 7)])
    first, again = log[0][1], log[2][1]
    assert len(set(first)) == 3 and tpaged.TRASH_BLOCK not in first
    assert log[0][2:4] == (4, 3) and log[1][2:4] == (7, 0)
    # FIFO recycling: freed ids come back after the untouched ones
    assert again == [4, 5, 6, 7, 1, 2, 3]


def test_allocator_rejects_double_reserved_and_foreign_frees():
    log = _run_both(8, [("alloc", 2), ("free", [1, 2]), ("free", [1, 2]),
                        ("free", [tpaged.TRASH_BLOCK]), ("free", [5])])
    for _, out, *_ in log[2:]:
        assert out[0] == "BlockAllocationError"
    assert log[-1][2:4] == (7, 0)               # nothing moved


def test_allocator_exhaustion_is_all_or_nothing_matches_reference():
    log = _run_both(4, [("alloc", 2), ("alloc", 2), ("alloc", 1)])
    assert log[1][1][0] == "BlockAllocationError"
    assert log[1][2] == 1                       # the failed alloc took nothing
    assert log[2][1] == [3] and log[2][5] == 3


def test_carve_is_fifo_off_the_free_list_matches_reference():
    log = _run_both(16, [("carve", 6), ("alloc", 9), ("free", list(
        range(7, 16)))])
    assert log[0][1] == list(range(1, 7))       # the same region every run
    assert log[0][2:5] == (16 - 1 - 6, 0, 6)    # carved is not live
    assert set(log[1][1]).isdisjoint(log[0][1])
    assert log[2][2:5] == (9, 0, 6)


def test_carve_shortage_and_carved_free_are_errors_matching_reference():
    log = _run_both(8, [("carve", 8), ("carve", 3), ("free", [1]),
                        ("alloc", 4), ("alloc", 5)])
    assert log[0][1] == ("BlockAllocationError", ["carving", "8"])
    assert log[1][1] == [1, 2, 3]
    assert log[2][1] == ("BlockAllocationError", ["freeing", "carved"])
    assert log[3][1] == [4, 5, 6, 7] and log[4][1][0] == "BlockAllocationError"
    with pytest.raises(ValueError):
        tpaged.BlockAllocator(8).carve(-1)


def test_gather_kv_addressing_matches_reference(rng):
    # position p of slot s lives at pages[table[s, p//bk], :, p%bk, :]
    nb, h, bk, d = 6, 2, 4, 8
    pages = rng.integers(-128, 128, (nb, h, bk, d)).astype(np.int8)
    table = np.asarray([[3, 1], [5, 2]], np.int32)
    out = tpaged.gather_kv(torch.from_numpy(pages), torch.from_numpy(table))
    assert out.shape == (2, h, 2 * bk, d)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jpaged.gather_kv(
        jnp.asarray(pages), jnp.asarray(table))))
    for s in range(2):
        for p in range(2 * bk):
            np.testing.assert_array_equal(out[s, :, p].numpy(),
                                          pages[table[s, p // bk], :, p % bk])


@pytest.mark.parametrize("s", [1, BK, 2 * BK + 3])
def test_write_blocks_lands_where_gather_reads(rng, s):
    """The prefill's block write (both layers, both rows, the last block
    zero-padded) read back through ``gather_kv`` at the same rows."""
    nb = 1 + B * MB
    pages = torch.from_numpy(rng.integers(-128, 128, (2, nb, H, BK, D)).astype(
        np.int8))
    n = tpaged.blocks_per_seq(s, BK)
    ids = torch.from_numpy(_table(rng)[:2, :n].copy())
    x_q = torch.from_numpy(rng.integers(-128, 128, (2, 2, H, s, D)).astype(
        np.int8))
    tpaged.write_blocks(pages, ids, x_q)
    for layer in range(2):
        got = tpaged.gather_kv(pages[layer], ids)
        assert torch.equal(got[:, :, :s], x_q[layer])
        assert not got[:, :, s:].any()
    with pytest.raises(ValueError, match="blocks"):
        tpaged.write_blocks(pages, ids[:, :0], x_q)
