"""Dense cache engine: the int8 paged KV block pool (port of
``repro/launch/engines/paged_kv.py``).

The allocator makes the same decisions in the same order as the
reference's, and every step rewrites the pool tensors in place.  The first
admitted request calibrates the pool's static per-layer scales; every later
admission quantizes with them.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import paged_kv
from repro_torch.launch import steps as st
from repro_torch.launch.engines import base
from repro_torch.models import transformer as T


class PagedKVEngine(base.CacheEngine):

    def __init__(self, params, cfg, prompts: List[np.ndarray], *,
                 slots: int, max_len: int, block_k: int = 32,
                 pool_blocks: Optional[int] = None):
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r}: the port "
                                      f"serves the dense family only")
        self.params = T.cast_for_serving(params, cfg)
        self.device = params["embed"]["table"].device
        self.cfg = cfg
        self.prompts = prompts
        self.slots = slots
        self.max_len = max_len
        self.block_k = block_k
        self.bps = paged_kv.blocks_per_seq(max_len, block_k)
        if pool_blocks is not None and pool_blocks < 1 + self.bps:
            raise ValueError(
                f"pool_blocks={pool_blocks} cannot hold one sequence: need "
                f">= 1 + {self.bps} (trash + blocks_per_seq("
                f"max_len={max_len}))")
        self.pool_size = (pool_blocks if pool_blocks is not None
                          else 1 + slots * self.bps)
        self.alloc: Optional[paged_kv.BlockAllocator] = None
        self.pager: Optional[base.PoolManager] = None
        self.calib_rid: Optional[int] = None
        self.calib_prefill = st.make_paged_prefill_step(cfg, calibrate=True)
        self.slot_prefill = st.make_paged_prefill_step(cfg, calibrate=False)
        self.decode_step = st.make_decode_step(cfg)

    def start_run(self):
        self.alloc = paged_kv.BlockAllocator(self.pool_size)
        self.pager = base.PoolManager(self.alloc, self.bps, self.block_k)
        self.calib_rid = None
        return T.make_paged_cache(self.cfg, self.slots, self.max_len,
                                  block_k=self.block_k,
                                  num_blocks=self.pool_size,
                                  device=self.device)

    def admission_need(self, rid: int) -> int:
        # the prompt plus this step's decode write
        return paged_kv.blocks_per_seq(len(self.prompts[rid]) + 1,
                                       self.block_k)

    def admit(self, cache, slot: int, rid: int):
        row = self.pager.admit_row(slot, len(self.prompts[rid]) + 1)
        if self.calib_rid is None:
            self.calib_rid = rid
        fn = self.calib_prefill if rid == self.calib_rid else \
            self.slot_prefill
        dev = self.device
        tokens = torch.as_tensor(self.prompts[rid], dtype=torch.int64,
                                 device=dev)[None]
        return fn(self.params, tokens, cache,
                  torch.tensor([slot], dtype=torch.int32, device=dev),
                  torch.as_tensor(row[None], dtype=torch.int32, device=dev))

    def short(self, slot: int, upto: int) -> int:
        return self.pager.short(slot, upto)

    def grow_blocks(self, slot: int, n: int):
        return self.pager.grow(slot, n)

    def grow_write(self, cache, slot: int, idx: int, block: int):
        cache["block_table"][slot, idx] = block
        return cache

    def decode(self, tokens, cache):
        return self.decode_step(self.params, tokens, cache)

    def release(self, cache, slot: int):
        self.pager.release(slot)
        paged_kv.release_slot(cache, slot)
        return cache

    def leaked(self) -> int:
        return self.alloc.live_count
