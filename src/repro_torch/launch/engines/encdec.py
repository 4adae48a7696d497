"""Encoder-decoder cache engine: the paged self-KV pool and a carved,
write-once cross-KV bank in the same pool (port of
``repro/launch/engines/encdec.py``).

The decoder's self-attention K/V page on demand exactly as in the dense
engine.  The encoder's cross K/V is the paper's weight-stationary bank:
computed at admission from the request's encoder frames, quantized into a
region carved out of the same block pool (``BlockAllocator.carve``: ids
that never return to the free list, ``cross_bps`` per slot) and read-only
for the request's lifetime.  Both attentions read int8 tiles through a
block table with the same decode kernel.

Preemption: releasing a slot frees only its dynamic self-KV blocks; the
carved region is overwritten by the next admission.  The carve is FIFO, so
every run addresses the same cross blocks, and a re-admission re-encodes
the same frames into them: preempt and resume stay bitwise, as in the
decoder-only engine.

All requests share one encoder length; the engine checks it at
construction.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import paged_kv
from repro_torch.launch import steps as st
from repro_torch.launch.engines import base
from repro_torch.models import encdec as E
from repro_torch.models import layers as L


class EncDecEngine(base.CacheEngine):
    pool_tag = "kv"
    warmup_prefills = 2
    warmup_decodes = 1

    def __init__(self, params, cfg, prompts: List[np.ndarray], *,
                 frames: List[np.ndarray], slots: int, max_len: int,
                 block_k: int = 32, pool_blocks: Optional[int] = None):
        if cfg.family != "encdec":
            raise ValueError(f"family {cfg.family!r}: the encoder-decoder "
                             f"engine serves the encdec family")
        if len(frames) != len(prompts):
            raise ValueError(f"{len(frames)} frame arrays for {len(prompts)} "
                             f"prompts")
        enc_len = frames[0].shape[0]
        if any(f.shape[0] != enc_len for f in frames):
            raise ValueError("one encoder length per run")
        self.params = E.cast_for_serving(params, cfg)
        self.device = L.param_device(params)
        self.cfg = cfg
        self.prompts = prompts
        self.frames = frames
        self.enc_len = enc_len
        self.slots = slots
        self.max_len = max_len
        self.block_k = block_k
        self.bps = paged_kv.blocks_per_seq(max_len, block_k)
        self.cross_bps = paged_kv.blocks_per_seq(enc_len, block_k)
        if pool_blocks is not None and pool_blocks < 1 + self.bps:
            raise ValueError(
                f"pool_blocks={pool_blocks} cannot hold one sequence: need "
                f">= 1 + {self.bps} (trash + blocks_per_seq("
                f"max_len={max_len}))")
        # --pool-blocks over-commits the dynamic self-KV region; the carved
        # cross bank is a fixed deployment cost on top
        dyn = pool_blocks if pool_blocks is not None else 1 + slots * self.bps
        self.pool_size = dyn + slots * self.cross_bps
        self.alloc: Optional[paged_kv.BlockAllocator] = None
        self.pager: Optional[base.PoolManager] = None
        self.calib_rid: Optional[int] = None
        self.cross_table: Optional[np.ndarray] = None
        self.calib_prefill = st.make_paged_prefill_step(cfg, calibrate=True)
        self.slot_prefill = st.make_paged_prefill_step(cfg, calibrate=False)
        self.decode_step = st.make_decode_step(cfg)

    def _carve(self):
        """A fresh allocator with the cross bank carved out.  The free list
        is FIFO, so the carved ids are the same every run: the bank's
        addresses belong to the deployment, not to the schedule."""
        alloc = paged_kv.BlockAllocator(self.pool_size)
        ids = alloc.carve(self.slots * self.cross_bps)
        return alloc, np.asarray(ids, np.int32).reshape(self.slots,
                                                        self.cross_bps)

    def make_cache(self, cross_table):
        return E.make_paged_cache(self.cfg, self.slots, self.max_len,
                                  block_k=self.block_k,
                                  num_blocks=self.pool_size,
                                  cross_table=cross_table,
                                  enc_len=self.enc_len, device=self.device)

    def start_run(self):
        self.alloc, self.cross_table = self._carve()
        self.pager = base.PoolManager(self.alloc, self.bps, self.block_k)
        self.calib_rid = None
        return self.make_cache(self.cross_table)

    def _inputs(self, rid: int):
        dev = self.device
        return (torch.as_tensor(self.frames[rid], dtype=torch.float32,
                                device=dev)[None],
                torch.as_tensor(self.prompts[rid], dtype=torch.int64,
                                device=dev)[None])

    def warmup(self):
        """One throwaway pass on a scratch pool of the same layout: the
        calibrating and the plain prefill of the first request, a table
        write, a decode step of every slot and a release.  It builds the
        kernels and warms the GEMM shapes before the clock starts."""
        dev = self.device
        alloc, table = self._carve()
        cache = self.make_cache(table)
        ids = alloc.alloc(self.bps)     # a whole row of real dynamic blocks
        row = torch.as_tensor([ids], dtype=torch.int32, device=dev)
        sid = torch.zeros((1,), dtype=torch.int32, device=dev)
        frames, prompt = self._inputs(0)
        self.calib_prefill(self.params, frames, prompt, cache, sid, row)
        last1, cache = self.slot_prefill(self.params, frames, prompt, cache,
                                         sid, row)
        cache = self.grow_write(cache, 0, self.bps - 1, ids[-1])
        tokens = torch.zeros((self.slots,), dtype=torch.int64, device=dev)
        out, cache = self.decode_step(self.params, tokens, cache)
        self.release_slot(cache, 0)
        out.cpu()
        return last1, out

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
        return fn(self.params, *self._inputs(rid), cache,
                  torch.tensor([slot], dtype=torch.int32, device=dev),
                  torch.as_tensor(row[None], dtype=torch.int32, device=dev))

    def short(self, slot: int, upto: int) -> int:
        return self.pager.short(slot, upto)

    def grow_blocks(self, slot: int, n: int):
        return self.pager.grow(slot, n)

    def grow_write(self, cache, slot: int, idx: int, block: int):
        cache["kv"]["block_table"][slot, idx] = block
        return cache

    def decode(self, tokens, cache):
        return self.decode_step(self.params, tokens, cache)

    @staticmethod
    def release_slot(cache, slot: int) -> None:
        """The slot's self-KV row to the trash block and its lengths to 0;
        the carved cross region has no table row to trash and is rewritten
        by the next admission."""
        cache["length"][slot] = 0
        paged_kv.release_slot(cache["kv"], slot)

    def release(self, cache, slot: int):
        self.pager.release(slot)
        self.release_slot(cache, slot)
        return cache

    def finalize(self, health, inj) -> None:
        inj.drain(self.alloc)
        health.pool(self.pool_tag, self.alloc)

    def leaked(self) -> int:
        return self.alloc.live_count

    def kv_bytes_per_step(self, gens) -> int:
        """Analytic decode read traffic: int8 self K/V at the mean live
        block occupancy plus the whole cross bank, both read every step."""
        mean_gen = sum(gens) // (2 * len(gens))
        mean_blocks = paged_kv.blocks_per_seq(len(self.prompts[0]) + mean_gen,
                                              self.block_k)
        return (2 * self.cfg.n_layers * self.slots * self.cfg.n_kv_heads
                * (mean_blocks + self.cross_bps) * self.block_k
                * self.cfg.hd)
