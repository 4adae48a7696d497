"""CacheEngine protocol: the family-specific half of the serving scheduler
(port of ``repro/launch/engines/base.py``).

The scheduler contract (see :func:`repro_torch.launch.scheduler.run_schedule`):

    cache = engine.start_run()          # fresh cache + allocator per run
    need  = engine.admission_need(rid)  # blocks to admit rid
    last1, cache = engine.admit(cache, slot, rid)   # per-slot prefill
    n = engine.short(slot, upto)        # blocks missing to cover upto
    start, ids = engine.grow_blocks(slot, n)        # host alloc (may raise)
    cache = engine.grow_write(cache, slot, idx, blk)  # device table write
    logits, cache = engine.decode(tokens, cache)    # one token per slot
    cache = engine.release(cache, slot)  # free blocks + trash the slot
    engine.finalize(health, inj)        # drain faults, record pool stats
    engine.leaked()                     # live blocks after the run (== 0)

An engine whose per-slot footprint is fixed (the SSM state slabs) keeps
``alloc`` None: the scheduler then skips every pool call, as the
reference's does, and the base class's ``admission_need``, ``short`` and
``leaked`` (0) and ``finalize`` (nothing) stand.

``engine.warmup()`` runs every step once on throwaway inputs before the
clock starts (``warmup_prefills`` prefills and ``warmup_decodes`` decode
steps) and returns ``(admit_logits, decode_logits)`` for the scheduler to
warm its sampler on.  Preemption needs no hook of its own: the snapshot is
the generated prefix on the host, and resume is an ordinary :meth:`admit`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import paged_kv


class PoolManager:
    """Host half of demand paging: slot -> block-id lists over a
    :class:`paged_kv.BlockAllocator`.  Allocation failures raise
    :class:`paged_kv.BlockAllocationError`."""

    def __init__(self, alloc: paged_kv.BlockAllocator, table_width: int,
                 block_k: int):
        self.alloc = alloc
        self.mb = table_width
        self.bk = block_k
        self.owned: Dict[int, List[int]] = {}

    def admit_row(self, slot: int, cover_len: int) -> np.ndarray:
        """Allocate coverage for ``cover_len`` positions; the full-width,
        trash-padded table row for the per-slot prefill."""
        ids = self.alloc.alloc(paged_kv.blocks_per_seq(cover_len, self.bk))
        self.owned[slot] = ids
        row = np.full((self.mb,), paged_kv.TRASH_BLOCK, np.int32)
        row[:len(ids)] = ids
        return row

    def short(self, slot: int, cover_len: int) -> int:
        """Blocks missing before the slot covers ``cover_len`` positions."""
        return (paged_kv.blocks_per_seq(cover_len, self.bk)
                - len(self.owned[slot]))

    def grow(self, slot: int, n: int):
        """Extend a slot by ``n`` blocks; (first_table_index, new_ids)."""
        ids = self.alloc.alloc(n)
        start = len(self.owned[slot])
        self.owned[slot].extend(ids)
        return start, ids

    def release(self, slot: int) -> None:
        self.alloc.free(self.owned.pop(slot))

    def reclaim_tail(self, slot: int, keep_len: int) -> int:
        """Free the blocks wholly past ``keep_len`` (speculative
        over-coverage); returns how many went back to the free list."""
        tail = paged_kv.tail_blocks(self.owned[slot], keep_len, self.bk)
        if tail:
            keep = paged_kv.blocks_per_seq(keep_len, self.bk)
            self.owned[slot] = self.owned[slot][:keep]
            self.alloc.free(tail)
        return len(tail)


class CacheEngine:
    """Base class of the cache engines (contract in the module docstring)."""

    slots: int = 0
    device = None                       # the torch.device the cache is on
    pool_tag: str = "kv"
    alloc: Optional[paged_kv.BlockAllocator] = None
    warmup_prefills: int = 0
    warmup_decodes: int = 0

    def start_run(self):
        raise NotImplementedError

    def warmup(self):
        return None

    def admission_need(self, rid: int) -> int:
        return 0

    def admit(self, cache, slot: int, rid: int):
        raise NotImplementedError

    def short(self, slot: int, upto: int) -> int:
        return 0

    def grow_blocks(self, slot: int, n: int):
        raise NotImplementedError

    def grow_write(self, cache, slot: int, idx: int, block: int):
        raise NotImplementedError

    def decode(self, tokens, cache):
        raise NotImplementedError

    def release(self, cache, slot: int):
        raise NotImplementedError

    def finalize(self, health, inj) -> None:
        pass

    def leaked(self) -> int:
        return 0

    def kv_bytes_per_step(self, gens) -> int:
        return 0
