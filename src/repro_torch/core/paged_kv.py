"""Paged int8 KV block pool: storage layout, block-table gather, allocator
(port of ``repro/core/paged_kv.py``).

The cache is a pool of fixed-size int8 blocks

    k_pages / v_pages : (n_layers, num_blocks, Hkv, block_k, head_dim)  int8

and each slot owns an ordered row of block ids, ``block_table (slots,
blocks_per_slot)``, so logical position ``p`` of slot ``s`` lives at
``pages[block_table[s, p // block_k], :, p % block_k, :]``.

Block id 0 is the **trash block**: a freed slot points its whole row at it,
so a retired slot that keeps stepping in the fixed-shape batch writes into
block 0 instead of a recycled block.  The decode and verify kernels never
read it.

Speculative serving adds a multi-token append (:func:`append_kv`) and
rollback after rejections: :func:`truncate_lengths` rewinds lengths only,
:func:`rollback_slot` and :func:`tail_blocks` also hand tail blocks back.

Unlike the JAX reference, which returns new arrays, the pool tensors here
are updated **in place** — the port's equivalent of ``donate_argnums``.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

import torch

TRASH_BLOCK = 0


class BlockAllocationError(RuntimeError):
    """Pool exhausted, double free, or free of an unallocated block; carries
    the allocator state so the message explains itself."""

    def __init__(self, msg: str, *, requested: Optional[int] = None,
                 free: Optional[int] = None, live: Optional[int] = None,
                 high_water: Optional[int] = None,
                 num_blocks: Optional[int] = None):
        super().__init__(msg)
        self.requested = requested
        self.free = free
        self.live = live
        self.high_water = high_water
        self.num_blocks = num_blocks


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` block ids.

    Reserved ids (by default the trash block) are never handed out; frees
    recycle ids FIFO; double frees, foreign ids, frees of carved ids and
    exhaustion raise :class:`BlockAllocationError`.  ``high_water`` is the
    peak live count.
    """

    def __init__(self, num_blocks: int,
                 reserved: Sequence[int] = (TRASH_BLOCK,)):
        if num_blocks <= len(set(reserved)):
            raise ValueError(f"pool of {num_blocks} blocks has no "
                             f"allocatable ids (reserved: {reserved})")
        self.num_blocks = num_blocks
        self._reserved = frozenset(reserved)
        self._free = deque(i for i in range(num_blocks)
                           if i not in self._reserved)
        self._live: set = set()
        self._carved: set = set()
        self.high_water = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return len(self._live)

    @property
    def carved_count(self) -> int:
        return len(self._carved)

    def _error(self, msg: str, requested: Optional[int] = None):
        return BlockAllocationError(
            msg, requested=requested, free=len(self._free),
            live=len(self._live), high_water=self.high_water,
            num_blocks=self.num_blocks)

    def carve(self, n: int) -> List[int]:
        """Take ``n`` ids off the free list for good, for a static region
        (the encoder-decoder engine's write-once cross-KV bank).  Carved
        ids are not live: they never return to the free list, cannot be
        freed and are not leaks.  All-or-nothing, as :meth:`alloc`."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            raise self._error(
                f"carving {n} blocks, only {len(self._free)} free "
                f"({len(self._live)} live of {self.num_blocks}, "
                f"high water {self.high_water})", requested=n)
        ids = [self._free.popleft() for _ in range(n)]
        self._carved.update(ids)
        return ids

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` block ids; all-or-nothing."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            raise self._error(
                f"requested {n} blocks, only {len(self._free)} free "
                f"({len(self._live)} live of {self.num_blocks}, "
                f"high water {self.high_water})", requested=n)
        ids = [self._free.popleft() for _ in range(n)]
        self._live.update(ids)
        self.high_water = max(self.high_water, len(self._live))
        return ids

    def free(self, ids: Iterable[int]) -> None:
        """Return blocks to the pool; rejects double frees and foreign ids."""
        ids = list(ids)
        for i in ids:
            if i in self._reserved:
                raise self._error(f"freeing reserved block {i}")
            if i in self._carved:
                raise self._error(f"freeing carved static block {i}")
            if i not in self._live:
                raise self._error(f"freeing block {i} that is not allocated "
                                  f"(double free or foreign id)")
        for i in ids:
            self._live.discard(i)
            self._free.append(i)


def blocks_per_seq(max_len: int, block_k: int) -> int:
    """Table width needed to hold ``max_len`` positions."""
    return -(-max_len // block_k)


def init_kv_pages(n_layers: int, num_blocks: int, n_kv_heads: int,
                  block_k: int, head_dim: int, slots: int,
                  blocks_per_slot: int, *, device) -> Dict[str, torch.Tensor]:
    """Zero-initialized paged pool + all-trash block table.

    The block dim is outside the head dim, so one (block, head) pair is a
    contiguous ``(block_k, head_dim)`` int8 tile — the decode kernel's
    k-tile, addressed straight from a table entry.
    """
    shape = (n_layers, num_blocks, n_kv_heads, block_k, head_dim)
    return {
        "k_pages": torch.zeros(shape, dtype=torch.int8, device=device),
        "v_pages": torch.zeros(shape, dtype=torch.int8, device=device),
        "scale_k": torch.full((n_layers, 1, 1, 1, 1), 1e-2,
                              dtype=torch.float32, device=device),
        "scale_v": torch.full((n_layers, 1, 1, 1, 1), 1e-2,
                              dtype=torch.float32, device=device),
        "block_table": torch.full((slots, blocks_per_slot), TRASH_BLOCK,
                                  dtype=torch.int32, device=device),
        "length": torch.zeros((slots,), dtype=torch.int32, device=device),
    }


def write_blocks(pages: torch.Tensor, block_ids: torch.Tensor,
                 x_q: torch.Tensor) -> None:
    """Write int8 ``x_q (L, B, H, S, d)`` into every layer's pool ``pages
    (L, num_blocks, H, block_k, d)`` in place: position ``p`` of row ``b``
    lands at ``pages[:, block_ids[b, p // block_k], :, p % block_k]``, the
    last block zero-padded.  ``block_ids (B, nb)`` holds exactly the
    ``ceil(S / block_k)`` blocks of each row."""
    nl, b, h, s, d = x_q.shape
    bk = pages.shape[3]
    nb = block_ids.shape[1]
    if nb != blocks_per_seq(s, bk):
        raise ValueError(f"{nb} blocks for {s} positions of block_k {bk}")
    x_q = torch.nn.functional.pad(x_q, (0, 0, 0, nb * bk - s))
    x_q = x_q.reshape(nl, b, h, nb, bk, d).permute(0, 1, 3, 2, 4, 5)
    pages[:, block_ids.reshape(-1).long()] = x_q.reshape(nl, b * nb, h, bk, d)


def gather_kv(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Contiguous K or V through the table (plain paths and tests only).

    pages (num_blocks, H, block_k, d) x table (B, mb) -> (B, H, mb*block_k, d).
    """
    b, mb = block_table.shape
    _, h, bk, d = pages.shape
    g = pages[block_table.long()]                 # (B, mb, H, bk, d)
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, mb * bk, d)


def release_slot(pool: Dict[str, torch.Tensor], slot: int) -> None:
    """Point a retired slot's table row at the trash block and zero its
    length, in place.  The allocator recycles the real blocks separately."""
    pool["block_table"][slot] = TRASH_BLOCK
    pool["length"][slot] = 0


# ---------------------------------------------------------------------------
# speculative decoding: multi-token append + rejection rollback
# ---------------------------------------------------------------------------

def append_kv(pages: torch.Tensor, block_table: torch.Tensor,
              base_len: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Scatter ``T`` new tokens per slot into one layer's pool, in place.

    ``vals (B, T, H, d)`` lands at logical positions ``base_len[b] + t``
    through the slot's table row.  Positions are clamped to the table's
    capacity, so an over-run slot (retired but still stepping) writes into
    its last addressed cell instead of past its row.
    """
    b, t = vals.shape[:2]
    mb = block_table.shape[1]
    bk = pages.shape[2]
    pos = torch.clamp_max(
        base_len.to(torch.int64)[:, None]
        + torch.arange(t, device=base_len.device)[None, :], mb * bk - 1)
    blk = torch.gather(block_table.to(torch.int64), 1, pos // bk)   # (B, T)
    # advanced indices (blk, pos % bk) are non-adjacent, so the indexed dims
    # come first: the target is (B, T, H, d), the shape of vals
    pages[blk, :, pos % bk, :] = vals
    return pages


def rollback_slot(pool: Dict[str, torch.Tensor], slot: int,
                  new_len: int) -> None:
    """Truncate one slot to ``new_len`` after a rejection, in place: its
    length drops and table entries past its last still-occupied block point
    at the trash block, so a later reuse of those blocks is never read
    through this slot's row.  The host frees the ids (:func:`tail_blocks`)."""
    bk = pool["k_pages"].shape[-2]
    keep = (new_len + bk - 1) // bk
    pool["block_table"][slot, keep:] = TRASH_BLOCK
    pool["length"][slot] = new_len


def tail_blocks(block_ids: Sequence[int], new_len: int,
                block_k: int) -> List[int]:
    """Host half of the rollback: the slot's block ids that lie wholly past
    ``new_len``, i.e. what goes back to the allocator.  The trash block is
    filtered out (freeing it would corrupt every retired slot)."""
    keep = blocks_per_seq(new_len, block_k)
    return [int(i) for i in block_ids[keep:] if int(i) != TRASH_BLOCK]


def truncate_lengths(pool: Dict[str, torch.Tensor],
                     new_lens: torch.Tensor) -> None:
    """Batch-wide length-only rewind after verify, in place.  Rejected
    tokens' K/V stay in the blocks past the logical end, masked by every
    kernel and overwritten by the next append; the slots keep their
    blocks."""
    pool["length"].copy_(new_lens)
