"""Continuous-batching schedulers (port of ``repro/launch/scheduler.py``:
``run_schedule`` on its greedy path, ``pick_victim`` and
``run_speculative``).

:func:`run_schedule` drives the CacheEngine protocol.  Per step: grow every
active slot's block coverage to its next write position, admit queued
requests FIFO into idle slots (one per-slot prefill each), decode one token
for every slot, and retire finished requests.  A pool too small for the
demand raises :class:`paged_kv.BlockAllocationError` there instead of
degrading.

:func:`run_speculative` is greedy speculative serving over the paged pool:
a draft burst of ``gamma`` tokens, one verify step of the target, greedy
acceptance plus a correction token.  Under pool pressure a slot parks for
the round, and only when every other slot is parked is one preempted and
later resumed by re-prefill, its recorded prefix asserted token by token.

Greedy selection is argmax on the device, first maximum on ties, as in the
reference; token streams are therefore comparable across the two packages.
Sampling, deadlines, fault injection, health records and straggler
detection are not ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import paged_kv
from repro_torch.launch import steps as st
from repro_torch.launch.engines import base as engines_base
from repro_torch.models import transformer as T


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


def pick_victim(active: Dict[int, int], exclude: int, policy: str,
                admit_seq: Dict[int, int],
                remaining: Callable[[int], int]) -> Optional[int]:
    """The slot to preempt under pool pressure, or None when ``exclude``
    (the grower itself) is the only active slot.

    ``newest`` evicts the most recently admitted slot, so the oldest
    requests finish first; ``longest`` evicts the slot with the most
    generation left, which frees its blocks for the longest time.
    """
    cands = [s for s in active if s != exclude]
    if not cands:
        return None
    if policy == "newest":
        return max(cands, key=lambda s: admit_seq[s])
    if policy != "longest":
        raise ValueError(f"preempt policy {policy!r}")
    return max(cands, key=lambda s: (remaining(s), admit_seq[s]))


def run_speculative(params, cfg, prompts: List[np.ndarray], *, slots: int,
                    gen: int, gamma: int = 4, draft=None, block_k: int = 32,
                    gens: Optional[Sequence[int]] = None,
                    pool_blocks: Optional[int] = None,
                    preempt_policy: str = "newest",
                    verbose: bool = False) -> Dict:
    """Greedy speculative serving; see
    :func:`repro_torch.launch.serve.serve_speculative` for the contract.

    ``draft`` is a ``(draft_params, draft_cfg)`` pair with its own pool, or
    None to self-draft with the target on the target's pool.  The two pools
    of a distinct drafter are grown, rolled back and released together.
    Returns ``served``, ``total_tokens``, ``tok_s``, ``wall_s``,
    ``p50_step_ms``/``p99_step_ms`` (one draft + verify round including the
    host read), ``slot_prefills`` (target and drafter), ``draft_steps`` and
    ``verify_steps`` (rounds), ``drafts_proposed``, ``drafts_accepted``,
    ``accept_rate``, ``tokens_per_verify``, ``preemptions``, ``resumes``,
    ``spec_parks``, ``admission_stalls``, ``leaked_blocks`` (both pools),
    ``gamma``, ``finished`` and ``failed`` (request id -> tokens).
    """
    self_draft = draft is None
    draft_params, dcfg = draft if draft is not None else (params, cfg)
    if cfg.family != "dense" or dcfg.family != "dense":
        raise NotImplementedError("speculative serving: the port serves the "
                                  "dense family only")
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError("the drafter must share the target's vocab")
    if preempt_policy not in ("newest", "longest"):
        raise ValueError(f"preempt policy {preempt_policy!r}")
    requests = len(prompts)
    slots = min(slots, requests)
    gens = list(gens) if gens is not None else [gen] * requests
    if len(gens) != requests:
        raise ValueError(f"{len(gens)} gens for {requests} prompts")
    # +gamma: the cache briefly holds the unaccepted draft tail before the
    # post-verify truncation
    max_len = max(len(p) for p in prompts) + max(gens) + gamma + 8
    bps = paged_kv.blocks_per_seq(max_len, block_k)
    if pool_blocks is not None and pool_blocks < 1 + bps:
        raise ValueError(
            f"pool_blocks={pool_blocks} cannot hold one sequence: need "
            f">= 1 + {bps} (trash + blocks_per_seq(max_len={max_len}))")
    pool_size = pool_blocks if pool_blocks is not None else 1 + slots * bps
    device = params["embed"]["table"].device

    params = T.cast_for_serving(params, cfg)
    draft_params = (params if self_draft
                    else T.cast_for_serving(draft_params, dcfg))

    def prefill_steps(c):        # keyed by whether the admission calibrates
        return {cal: st.make_paged_prefill_step(c, calibrate=cal)
                for cal in (True, False)}

    prefill = prefill_steps(cfg)
    d_prefill = None if self_draft else prefill_steps(dcfg)
    draft_loop = st.make_draft_loop(dcfg, gamma)
    verify_step = st.make_verify_step(cfg)

    def new_pool(c):
        return (engines_base.PoolManager(paged_kv.BlockAllocator(pool_size),
                                         bps, block_k),
                T.make_paged_cache(c, slots, max_len, block_k=block_k,
                                   num_blocks=pool_size, device=device))

    # (pager, cache) of every pool a slot holds blocks in, target first
    pools = [new_pool(cfg)] + ([] if self_draft else [new_pool(dcfg)])
    pager, cache = pools[0]
    d_pager, dcache = pools[1] if not self_draft else (None, None)

    stats: Dict = {"slot_prefills": 0, "draft_steps": 0, "verify_steps": 0,
                   "drafts_proposed": 0, "drafts_accepted": 0,
                   "preemptions": 0, "resumes": 0, "spec_parks": 0,
                   "admission_stalls": 0, "gamma": gamma, "step_s": []}
    queue = deque(range(requests))
    generated: Dict[int, List[int]] = {}
    finished: Dict[int, List[int]] = {}
    failed: Dict[int, List[int]] = {}
    resume_prefix: Dict[int, List[int]] = {}
    expect: Dict[int, List[int]] = {}       # recorded prefix, re-asserted
    admit_seq: Dict[int, int] = {}
    active: Dict[int, int] = {}
    parked: set = set()                     # slots sitting this round out
    seq_counter = 0
    calib_rid: Optional[int] = None
    cur_lens = np.zeros((slots,), np.int32)
    pend_h = np.zeros((slots,), np.int64)
    step = 0

    def free_slot(slot):
        for pg, c in pools:
            pg.release(slot)
            paged_kv.release_slot(c, slot)
        # a distinct drafter's table stays in lockstep with the target's
        assert d_pager is None or set(d_pager.owned) == set(pager.owned)
        cur_lens[slot] = 0

    def preempt(vslot, *, reason):
        rid = active.pop(vslot)
        resume_prefix[rid] = generated.pop(rid)
        expect.pop(rid, None)
        free_slot(vslot)
        queue.appendleft(rid)
        stats["preemptions"] += 1
        if verbose:
            print(f"[serve-spec] step {step}: preempted request {rid} "
                  f"(slot {vslot}, {reason})", flush=True)

    def park(slot):
        """Skip this slot's round and give back its own over-coverage tail
        (blocks past the accepted prefix) on every pool.  Its own tail only:
        another slot's gamma coverage is what that slot's draft writes into
        this round."""
        keep = int(cur_lens[slot])
        for pg, c in pools:
            pg.reclaim_tail(slot, keep)
            paged_kv.rollback_slot(c, slot, keep)
        parked.add(slot)
        stats["spec_parks"] += 1

    def grow(slot, upto, pg, c) -> bool:
        """Cover ``upto`` positions for one slot on one pool; park, then
        preempt, under pressure.  False once the slot is out of the round."""
        while slot in active and pg.short(slot, upto) > 0:
            try:
                start, ids = pg.grow(slot, pg.short(slot, upto))
            except paged_kv.BlockAllocationError:
                if any(s != slot and s not in parked for s in active):
                    # another slot still speculates this round, so sitting
                    # it out cannot stall the whole batch
                    park(slot)
                    return False
                victim = pick_victim(
                    active, slot, preempt_policy, admit_seq,
                    lambda s: gens[active[s]] - len(generated[active[s]]))
                if victim is None:
                    preempt(slot, reason="self")
                    return False
                preempt(victim, reason="growth")
                parked.discard(victim)
                continue
            for j, blk in enumerate(ids):
                c["block_table"][slot, start + j] = blk
        return slot in active and slot not in parked

    t0 = time.perf_counter()
    while active or queue:
        # ---- growth: every slot needs len + gamma coverage this round ----
        parked.clear()
        for slot in sorted(active):
            if slot not in active:
                continue
            upto = int(cur_lens[slot]) + gamma
            if grow(slot, upto, pager, cache) and not self_draft:
                grow(slot, upto, d_pager, dcache)

        # ---- admission: FIFO into idle slots, both pools at once ---------
        idle = [s for s in range(slots) if s not in active]
        while queue and idle:
            rid = queue[0]
            s_len = len(prompts[rid])
            need = paged_kv.blocks_per_seq(s_len + gamma, block_k)
            if any(pg.alloc.free_count < need for pg, _ in pools):
                stats["admission_stalls"] += 1
                break
            queue.popleft()
            slot = idle.pop(0)
            if calib_rid is None:
                calib_rid = rid
            calibrate = rid == calib_rid
            sid = torch.tensor([slot], dtype=torch.int32, device=device)
            prompt = torch.as_tensor(prompts[rid], dtype=torch.int64,
                                     device=device)[None]
            rows = [torch.as_tensor(pg.admit_row(slot, s_len + gamma)[None],
                                    device=device) for pg, _ in pools]
            last1, _ = prefill[calibrate](params, prompt, cache, sid, rows[0])
            if not self_draft:
                d_prefill[calibrate](draft_params, prompt, dcache, sid,
                                     rows[1])
            stats["slot_prefills"] += len(pools)
            active[slot] = rid
            admit_seq[slot] = seq_counter
            seq_counter += 1
            if not bool(torch.isfinite(last1[0]).all()):
                failed[rid] = []
                del active[slot]
                free_slot(slot)
                idle.insert(0, slot)
                continue
            first = int(torch.argmax(last1[0]))
            if rid in resume_prefix:
                pre = resume_prefix.pop(rid)
                if first != pre[0]:
                    raise RuntimeError(
                        f"resume divergence for request {rid}: re-prefill "
                        f"token {first} != recorded {pre[0]}")
                expect[rid] = pre
                stats["resumes"] += 1
            generated[rid] = [first]
            pend_h[slot] = first
            cur_lens[slot] = s_len
            if verbose:
                print(f"[serve-spec] step {step}: admitted request {rid} "
                      f"into slot {slot}", flush=True)

        if not active:
            step += 1
            continue

        # ---- one draft -> verify -> accept round ---------------------------
        pending = torch.as_tensor(pend_h, device=device)
        ts = time.perf_counter()
        if self_draft:
            drafts, _ = draft_loop(params, pending, cache)
            # length-only rewind: verify overwrites the draft K/V rows
            paged_kv.truncate_lengths(cache, torch.as_tensor(cur_lens,
                                                             device=device))
        else:
            drafts, _ = draft_loop(draft_params, pending, dcache)
        verify_in = torch.cat([pending[:, None], drafts[:, :-1]], dim=1)
        vlogits, _ = verify_step(params, verify_in, cache)
        # argmax and the finite guard in one host read: a non-finite value
        # anywhere in a slot's verify logits retires that slot
        ok = torch.isfinite(vlogits).all(dim=-1).all(dim=-1)
        host = torch.cat([drafts, torch.argmax(vlogits, dim=-1),
                          ok[:, None].to(drafts.dtype)], dim=1).cpu().numpy()
        stats["step_s"].append(time.perf_counter() - ts)
        stats["draft_steps"] += 1
        stats["verify_steps"] += 1
        drafts_h, targets_h = host[:, :gamma], host[:, gamma:2 * gamma]
        ok_h = host[:, 2 * gamma].astype(bool)

        new_lens = np.zeros((slots,), np.int32)
        retiring: List[int] = []
        for slot in sorted(active):
            rid = active[slot]
            if slot in parked:
                # sat the round out: nothing emitted, the prefix stays; its
                # draft row read through trashed entries, so its discarded
                # logits are exempt from the finite guard
                new_lens[slot] = cur_lens[slot]
                continue
            if not ok_h[slot]:
                failed[rid] = generated.pop(rid)
                del active[slot]
                expect.pop(rid, None)
                free_slot(slot)
                continue
            k = 0
            while k < gamma and drafts_h[slot, k] == targets_h[slot, k]:
                k += 1
            emit = [int(x) for x in drafts_h[slot, :k]]
            if k < gamma:
                emit.append(int(targets_h[slot, k]))     # correction token
            emit = emit[:gens[rid] - len(generated[rid])]
            stats["drafts_proposed"] += gamma
            stats["drafts_accepted"] += min(k, len(emit))
            generated[rid].extend(emit)
            pend_h[slot] = generated[rid][-1]
            if rid in expect:
                # the bitwise resume contract, asserted live
                want, got = expect[rid], generated[rid]
                n = min(len(want), len(got))
                if got[:n] != want[:n]:
                    at = next(i for i in range(n) if got[i] != want[i])
                    raise RuntimeError(f"resume divergence for request {rid} "
                                       f"at token {at}")
                if len(got) >= len(want):
                    del expect[rid]
            if len(generated[rid]) >= gens[rid]:
                retiring.append(slot)
            else:
                new_lens[slot] = len(prompts[rid]) + len(generated[rid]) - 1

        # rewind to the accepted prefixes in one shot; retiring and idle
        # slots truncate to zero
        lens_dev = torch.as_tensor(new_lens, device=device)
        for _, c in pools:
            paged_kv.truncate_lengths(c, lens_dev)
        cur_lens[:] = new_lens
        for slot in retiring:
            rid = active.pop(slot)
            finished[rid] = generated.pop(rid)
            expect.pop(rid, None)
            free_slot(slot)
        step += 1

    stats["leaked_blocks"] = sum(pg.alloc.live_count for pg, _ in pools)
    stats["finished"] = finished
    stats["failed"] = failed
    stats["accept_rate"] = (stats["drafts_accepted"]
                            / max(stats["drafts_proposed"], 1))
    emitted = sum(len(v) for v in finished.values()) - len(finished)
    stats["tokens_per_verify"] = emitted / max(stats["verify_steps"], 1)
    return finalize_stats(stats, finished, t0)
