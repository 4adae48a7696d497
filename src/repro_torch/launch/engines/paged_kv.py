"""Dense/MoE cache engine: the int8 paged KV block pool (port of
``repro/launch/engines/paged_kv.py``).

The allocator makes the same decisions in the same order as the
reference's, and every step rewrites the pool tensors in place.  The first
admitted request calibrates the pool's static per-layer scales; every later
admission quantizes with them.  Each admission is an ``engine.admit``
span (``repro_torch/trace.py``) with its ``rid``, ``slot`` and
``prompt_len``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import paged_kv
from repro_torch.launch import steps as st
from repro_torch.launch.engines import base
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


class PagedKVEngine(base.CacheEngine):
    warmup_prefills = 2
    warmup_decodes = 1

    def __init__(self, params, cfg, prompts: List[np.ndarray], *,
                 slots: int, max_len: int, block_k: int = 32,
                 pool_blocks: Optional[int] = None):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"family {cfg.family!r}: the paged engine serves the dense "
                f"and MoE families (ssm: SSMStateEngine; encdec: "
                f"EncDecEngine)")
        self.params = T.cast_for_serving(params, cfg)
        self.device = L.param_device(params)
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

    def make_cache(self):
        return T.make_paged_cache(self.cfg, self.slots, self.max_len,
                                  block_k=self.block_k,
                                  num_blocks=self.pool_size,
                                  device=self.device)

    def start_run(self):
        self.alloc = paged_kv.BlockAllocator(self.pool_size)
        self.pager = base.PoolManager(self.alloc, self.bps, self.block_k)
        self.calib_rid = None
        return self.make_cache()

    def warmup(self):
        """One throwaway pass on a scratch pool of the same size: the
        calibrating and the plain prefill of the first prompt, a table
        write, a decode step of every slot and a release.  It builds the
        kernels, raises their shared-memory limits and warms the GEMM
        shapes before the clock starts."""
        dev = self.device
        cache = self.make_cache()
        # every table entry a real block (the pool holds >= 1 + bps)
        row = torch.arange(1, self.bps + 1, dtype=torch.int32,
                           device=dev)[None]
        prompt = torch.as_tensor(self.prompts[0], dtype=torch.int64,
                                 device=dev)[None]
        sid = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.calib_prefill(self.params, prompt, cache, sid, row)
        last1, cache = self.slot_prefill(self.params, prompt, cache, sid, row)
        cache = self.grow_write(cache, 0, 1, 2)
        tokens = torch.zeros((self.slots,), dtype=torch.int64, device=dev)
        out, cache = self.decode_step(self.params, tokens, cache)
        paged_kv.release_slot(cache, 0)
        out.cpu()
        return last1, out

    def admission_need(self, rid: int) -> int:
        # the prompt plus this step's decode write
        return paged_kv.blocks_per_seq(len(self.prompts[rid]) + 1,
                                       self.block_k)

    def admit(self, cache, slot: int, rid: int):
        plen = len(self.prompts[rid])
        with trace.span("engine.admit", rid=rid, slot=slot, prompt_len=plen):
            row = self.pager.admit_row(slot, plen + 1)
            if self.calib_rid is None:
                self.calib_rid = rid
            fn = self.calib_prefill if rid == self.calib_rid else \
                self.slot_prefill
            dev = self.device
            tokens = torch.as_tensor(self.prompts[rid], dtype=torch.int64,
                                     device=dev)[None]
            return fn(self.params, tokens, cache,
                      torch.tensor([slot], dtype=torch.int32, device=dev),
                      torch.as_tensor(row[None], dtype=torch.int32,
                                      device=dev))

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

    def finalize(self, health, inj) -> None:
        inj.drain(self.alloc)
        health.pool(self.pool_tag, self.alloc)

    def leaked(self) -> int:
        return self.alloc.live_count

    def kv_bytes_per_step(self, gens) -> int:
        """Analytic decode read traffic: int8 K and V at the mean live
        block occupancy."""
        mean_gen = sum(gens) // (2 * len(gens))
        mean_blocks = paged_kv.blocks_per_seq(len(self.prompts[0]) + mean_gen,
                                              self.block_k)
        return (2 * self.cfg.n_layers * self.slots * self.cfg.n_kv_heads
                * mean_blocks * self.block_k * self.cfg.hd)
