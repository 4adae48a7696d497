"""Continuous-batching scheduler over the CacheEngine protocol (port of
``repro/launch/scheduler.py::run_schedule``, greedy path).

Per step: grow every active slot's block coverage to its next write
position, admit queued requests FIFO into idle slots (one per-slot prefill
each), decode one token for every slot, and retire finished requests.
Greedy selection is argmax on the device, first maximum on ties, as in
the reference; token streams are therefore comparable across the two
packages.

Preemption and replay, deadlines, fault injection, health records,
straggler detection and sampling are not ported yet.  A pool too small
for the demand raises :class:`paged_kv.BlockAllocationError` instead of
degrading.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import paged_kv
from repro_torch.launch.engines import base as engines_base


def percentile(xs: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs), p)) if xs else 0.0


def finalize_stats(stats: Dict, finished: Dict, t0: float) -> Dict:
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in finished.values())
    step_s = stats.pop("step_s")
    stats.update(
        served=len(finished),
        total_tokens=total,
        wall_s=dt,
        tok_s=total / max(dt, 1e-9),
        p50_step_ms=percentile(step_s, 50) * 1e3,
        p99_step_ms=percentile(step_s, 99) * 1e3,
    )
    return stats


def run_schedule(engine: engines_base.CacheEngine,
                 prompts: List[np.ndarray], *, gens: Sequence[int],
                 verbose: bool = False) -> Dict:
    """Drive the greedy continuous-batching loop over ``engine``.

    Returns ``served``, ``total_tokens``, ``wall_s``, ``tok_s``,
    ``decode_steps``, ``slot_prefills``, ``p50_step_ms``/``p99_step_ms``
    (one decode step including the host read of its tokens), ``finished``
    (request id -> generated tokens) and ``leaked_blocks``.
    """
    slots = engine.slots
    gens = list(gens)
    if len(gens) != len(prompts):
        raise ValueError(f"{len(gens)} gens for {len(prompts)} prompts")

    cache = engine.start_run()
    alloc = engine.alloc
    stats: Dict = {"slot_prefills": 0, "decode_steps": 0, "step_s": []}
    queue = deque(range(len(prompts)))
    generated: Dict[int, List[int]] = {}
    finished: Dict[int, List[int]] = {}
    active: Dict[int, int] = {}
    tokens = torch.zeros((slots,), dtype=torch.int64,
                         device=cache["length"].device)
    step = 0

    t0 = time.perf_counter()
    while active or queue:
        # ---- growth: cover this step's write position for every slot -----
        for slot in sorted(active):
            rid = active[slot]
            upto = len(prompts[rid]) + len(generated[rid])
            n = engine.short(slot, upto)
            if n > 0:
                start, ids = engine.grow_blocks(slot, n)
                for j, blk in enumerate(ids):
                    cache = engine.grow_write(cache, slot, start + j, blk)

        # ---- admission: fill idle slots from the queue, FIFO -------------
        idle = [s for s in range(slots) if s not in active]
        while queue and idle:
            rid = queue[0]
            need = engine.admission_need(rid)
            if alloc.free_count < need:
                if not active:
                    raise paged_kv.BlockAllocationError(
                        f"request {rid} needs {need} blocks, the idle pool "
                        f"has {alloc.free_count}", requested=need,
                        free=alloc.free_count, live=alloc.live_count,
                        num_blocks=alloc.num_blocks)
                break                        # wait for a retirement
            queue.popleft()
            slot = idle.pop(0)
            last1, cache = engine.admit(cache, slot, rid)
            stats["slot_prefills"] += 1
            active[slot] = rid
            first = int(torch.argmax(last1[0]))
            generated[rid] = [first]
            tokens[slot] = first
            if verbose:
                print(f"[serve] step {step}: admitted request {rid} "
                      f"into slot {slot}", flush=True)

        # ---- decode one token per slot ----------------------------------
        ts = time.perf_counter()
        logits, cache = engine.decode(tokens, cache)
        tokens = torch.argmax(logits, dim=-1)
        tok_host = tokens.cpu().numpy()
        stats["step_s"].append(time.perf_counter() - ts)
        stats["decode_steps"] += 1

        for slot in sorted(active):
            rid = active[slot]
            generated[rid].append(int(tok_host[slot]))
            if len(generated[rid]) >= gens[rid]:
                finished[rid] = generated.pop(rid)
                del active[slot]
                cache = engine.release(cache, slot)
        step += 1

    stats["leaked_blocks"] = engine.leaked()
    stats["finished"] = finished
    return finalize_stats(stats, finished, t0)
