"""Continuous-batching schedulers (port of ``repro/launch/scheduler.py``).

:func:`run_schedule` drives the CacheEngine protocol.  Per step: run the
fault hooks, grow every active slot's block coverage to its next write
position (under pool pressure preempt a victim, or the slot itself when it
is alone), admit queued requests into idle slots (FIFO, or earliest
deadline first under ``deadline_ms``; a short pool stalls admission), decode
one token for every slot, and retire finished, expired and non-finite
requests.  A preempted request is re-queued first with its generated
prefix; on re-admission its prompt is re-prefilled through the same step
and the prefix replayed through the ordinary decode batch, so its tokens
are those of a run that was never preempted.

:func:`run_speculative` is greedy speculative serving over the paged pool:
a draft burst of ``gamma`` tokens, one verify step of the target, greedy
acceptance plus a correction token.  Under pool pressure a slot parks for
the round, and only when every other slot is parked is one preempted and
later resumed by re-prefill, its recorded prefix asserted token by token.

Both loops record every degradation (preemption, resume, stall, park,
deadline, NaN retirement, injected fault) in a
:class:`repro_torch.launch.health.ServeHealth` and time every iteration
through a :class:`repro_torch.dist.straggler.StragglerWatchdog`.
:func:`run_schedule`'s iterations, first-token reads, decode calls and
sampling reads are spans (``repro_torch/trace.py``), on the watchdog's own
stamps where it takes them.

Token selection (:func:`make_sampler`): greedy is argmax on the device,
first maximum on ties, as in the reference, so greedy token streams are
comparable across the two packages.  Sampling draws with the port's own
count-addressed keys (:class:`RequestKeys`), which keep the reference's
guarantee, a request's n-th draw a pure function of ``(sample_seed, rid,
n)``, but not its numbers: sampled tokens compare within the port only.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import paged_kv
from repro_torch.dist import straggler as strag
from repro_torch.launch import faults as faults_mod
from repro_torch.launch import steps as st
from repro_torch.launch.engines import base as engines_base
from repro_torch.launch.health import ServeHealth
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``0 <= x, c < 2**32``, in 16-bit halves so
    that no int64 product overflows; ``x`` an int or an int64 tensor."""
    return ((x & 0xFFFF) * c + (((x >> 16) * c) & 0xFFFF) * 65536) & _M32


def _mix32(x):
    """A bijective 32-bit integer hash (lowbias32); same ops on a Python
    int, a CPU tensor and a CUDA tensor, same result."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class RequestKeys:
    """Per-request, count-addressed sampling keys.

    ``key(rid, drawn)`` is a 32-bit hash of the seed, the request id and
    how many tokens the request has drawn, and nothing of the scheduler's
    history (admission order, slot, co-residents, preemptions): a resumed
    request replays its prefix and then draws exactly what the
    uninterrupted run draws.  ``base`` stands in for a slot with no live
    request, whose token is discarded.
    """

    def __init__(self, seed: int):
        self.base = _mix32(_mix32((seed & _M32) ^ 0x9E3779B9)
                           ^ ((seed >> 32) & _M32))

    def key(self, rid: int, drawn: int) -> int:
        return _mix32(_mix32(self.base ^ (rid & _M32)) ^ (drawn & _M32))


def make_sampler(temperature: float, top_p: float, vocab_size: int):
    """Token selector: ``(logits (B, V_padded), keys) -> (tokens (B,) int64,
    finite (B,) bool)``.

    ``temperature == 0`` is greedy argmax, the keys ignored.  Otherwise:
    lanes ``>= vocab_size`` (padding) are masked to -inf, the logits scaled
    by ``1 / temperature`` and cut to the ``top_p`` nucleus (the smallest
    prefix of the sorted distribution with mass >= ``top_p``; the top token
    always stays), and each row draws by Gumbel-max with uniforms hashed
    from ``(keys[row], lane)`` in int64 tensor ops: the same uniforms on
    the CPU and on the card, one batch of elementwise launches per step.
    ``keys`` is one :class:`RequestKeys` key per row.

    The second output is the finite guard, computed on the raw logits: a
    row that is not all finite made a garbage token, and the scheduler
    retires its request.
    """
    if temperature == 0.0:
        def greedy(logits, keys=None):
            ok = torch.isfinite(logits).all(dim=-1)
            return torch.argmax(logits, dim=-1), ok
        return greedy

    def sample(logits, keys):
        ok = torch.isfinite(logits).all(dim=-1)
        dev = logits.device
        lane = torch.arange(logits.shape[-1], dtype=torch.int64, device=dev)
        lg = logits.to(torch.float32) / temperature
        lg = torch.where(lane >= vocab_size, -torch.inf, lg)
        if top_p < 1.0:
            srt = torch.sort(lg, dim=-1, descending=True).values
            probs = torch.softmax(srt, dim=-1)
            keep = torch.cumsum(probs, dim=-1) - probs < top_p
            cutoff = torch.where(keep, srt, torch.inf).amin(dim=-1,
                                                            keepdim=True)
            lg = torch.where(lg < cutoff, -torch.inf, lg)
        k = torch.as_tensor(keys, dtype=torch.int64, device=dev)
        bits = _mix32(k[:, None] ^ _mix32(lane ^ 0x85EBCA6B)[None, :])
        # 23 random bits + 1/2, exact in f32: u in (0, 1)
        u = ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(lg + gumbel, dim=-1), ok

    return sample


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


def best_of(run: Callable[[], Dict], repeats: int) -> Dict:
    """``repeats`` runs of the whole schedule; the one with the most tok/s."""
    best = run()
    for _ in range(repeats - 1):
        other = run()
        if other["tok_s"] > best["tok_s"]:
            best = other
    return best


def _watchdog(health: ServeHealth) -> strag.StragglerWatchdog:
    return strag.StragglerWatchdog(window=50, threshold=3.0, min_history=4,
                                   on_straggler=health.straggler)


def _check_policy(policy: str) -> None:
    if policy not in ("newest", "longest"):
        raise ValueError(f"preempt policy {policy!r}")


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
    _check_policy(policy)
    return max(cands, key=lambda s: (remaining(s), admit_seq[s]))


def run_schedule(engine: engines_base.CacheEngine,
                 prompts: List[np.ndarray], *, gens: Sequence[int],
                 temperature: float = 0.0, top_p: float = 1.0,
                 sample_seed: int = 0, preempt_policy: str = "newest",
                 deadline_steps: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 fault_plan: Optional[faults_mod.FaultPlan] = None,
                 warmup: bool = False, repeats: int = 1,
                 verbose: bool = False) -> Dict:
    """Drive the continuous-batching loop over ``engine``.

    ``temperature``/``top_p``/``sample_seed`` select tokens
    (:func:`make_sampler`); ``preempt_policy`` picks victims under pool
    pressure (:func:`pick_victim`); ``deadline_steps`` and ``deadline_ms``
    expire a request that many steps or milliseconds after its first
    admission, and ``deadline_ms`` makes admission earliest-deadline-first
    (victims still resume first); ``fault_plan`` injects faults.
    ``warmup`` runs the engine's throwaway pass before the clock starts;
    ``repeats`` reruns the whole schedule and keeps the fastest run.

    Returns ``served``, ``total_tokens``, ``wall_s``, ``tok_s``,
    ``decode_steps``, ``slot_prefills``, ``batch_prefills`` (0),
    ``p50_step_ms``/``p99_step_ms`` (one decode step including the host
    read of its tokens), ``finished``, ``expired`` and ``failed`` (request
    id -> tokens), ``preemptions``, ``resumes``, ``leaked_blocks``,
    ``health`` (:meth:`ServeHealth.to_dict` plus ``straggler_summary``),
    ``kv_bytes_per_step``, and ``warmup_prefills``/``warmup_decode_steps``
    (what the warm-up ran, before the clock).
    """
    requests = len(prompts)
    slots = engine.slots
    gens = list(gens)
    if len(gens) != requests:
        raise ValueError(f"{len(gens)} gens for {requests} prompts")
    _check_policy(preempt_policy)
    sampler = make_sampler(temperature, top_p, engine.cfg.vocab_size)

    warm = engine.warmup() if warmup else None
    if warm is not None:
        keys = RequestKeys(sample_seed)
        w_l1, w_out = warm
        sampler(w_l1, [keys.base] * w_l1.shape[0])
        sampler(w_out, [keys.base] * w_out.shape[0])

    def _run() -> Dict:
        # fresh scheduler state per run; the engine's steps are shared
        cache = engine.start_run()
        alloc = engine.alloc
        paged = alloc is not None       # fixed-footprint engines: no pool
        device = engine.device
        health = ServeHealth()
        inj = faults_mod.FaultInjector(fault_plan, health)
        watchdog = _watchdog(health)
        keys = RequestKeys(sample_seed)

        def select(logits, rows):
            """``rows``: per logit row (rid, tokens drawn), or None for a
            slot with no live request (its token is discarded)."""
            ks = [keys.base if r is None else keys.key(*r) for r in rows]
            return sampler(logits, ks)

        stats: Dict = {"batch_prefills": 0, "slot_prefills": 0,
                       "decode_steps": 0, "step_s": []}
        queue = deque(range(requests))
        generated: Dict[int, List[int]] = {}
        finished: Dict[int, List[int]] = {}
        expired: Dict[int, List[int]] = {}
        failed: Dict[int, List[int]] = {}
        resume_prefix: Dict[int, List[int]] = {}
        replay: Dict[int, List[int]] = {}
        admit_step0: Dict[int, int] = {}    # first admission, for deadlines
        admit_t0: Dict[int, float] = {}     # its wall clock
        admit_seq: Dict[int, int] = {}      # per-slot admission order
        active: Dict[int, int] = {}
        seq_counter = 0
        tokens = torch.zeros((slots,), dtype=torch.int64, device=device)
        step = 0

        def free_slot(slot):
            nonlocal cache
            cache = engine.release(cache, slot)

        def preempt(vslot, *, reason):
            rid = active.pop(vslot)
            pre = generated.pop(rid) + replay.pop(rid, [])
            resume_prefix[rid] = pre
            free_slot(vslot)
            queue.appendleft(rid)           # victims resume first
            health.count("preemptions")
            health.event("preempt", step, rid=rid, slot=vslot,
                         policy=preempt_policy, reason=reason,
                         prefix_tokens=len(pre))
            if verbose:
                print(f"[serve] step {step}: preempted request {rid} "
                      f"(slot {vslot}, {reason})", flush=True)

        def budget_ms(rid, now):
            """Remaining wall-clock budget; all of it if never admitted."""
            if rid in admit_t0:
                return deadline_ms - (now - admit_t0[rid]) * 1e3
            return deadline_ms

        def retire(slot, into: Dict[int, List[int]]):
            rid = active.pop(slot)
            into[rid] = generated.pop(rid)
            replay.pop(rid, None)
            free_slot(slot)

        t0 = time.perf_counter()
        while active or queue:
            ts_iter = time.perf_counter()
            it = trace.span("sched.iteration", start=ts_iter, step=step)
            prefills0 = stats["slot_prefills"]
            preempts0 = health.counters["preemptions"]
            inj.on_step(step)
            if paged:
                inj.squeeze_pool(step, alloc)
            fslot = inj.force_preempt(step)
            if fslot is not None and fslot in active:
                preempt(fslot, reason="fault")

            # ---- growth: cover this step's write position for every
            # slot; on exhaustion preempt a victim and retry (an engine
            # without a pool has nothing to grow) -------------------------
            if paged:
                for slot in sorted(active):
                    if slot not in active:
                        continue            # preempted by an earlier grower
                    rid = active[slot]
                    upto = len(prompts[rid]) + len(generated[rid])
                    while engine.short(slot, upto) > 0:
                        try:
                            start, ids = engine.grow_blocks(
                                slot, engine.short(slot, upto))
                        except paged_kv.BlockAllocationError as e:
                            health.event("pool_pressure", step, slot=slot,
                                         requested=e.requested, free=e.free,
                                         live=e.live,
                                         high_water=e.high_water)
                            victim = pick_victim(
                                active, slot, preempt_policy, admit_seq,
                                lambda s: gens[active[s]]
                                - len(generated[active[s]]))
                            if victim is None:
                                # the sole active slot: park it in the
                                # queue until the pool (a fault hold)
                                # drains
                                preempt(slot, reason="self")
                                break
                            preempt(victim, reason="growth")
                            continue
                        for j, blk in enumerate(ids):
                            cache = engine.grow_write(cache, slot,
                                                      start + j, blk)

            # ---- admission: fill idle slots from the queue --------------
            idle = [s for s in range(slots) if s not in active]
            while queue and idle:
                if deadline_ms is None or len(queue) == 1:
                    qi = 0
                else:
                    # earliest deadline first under deadline_ms
                    now = time.perf_counter()
                    qi = min(range(len(queue)),
                             key=lambda i: (budget_ms(queue[i], now), i))
                rid = queue[qi]
                need = engine.admission_need(rid)
                if paged and alloc.free_count < need:
                    health.count("admission_stalls")
                    health.event("admission_stall", step, rid=rid,
                                 need=need, free=alloc.free_count)
                    break
                del queue[qi]
                slot = idle.pop(0)
                last1, cache = engine.admit(cache, slot, rid)
                stats["slot_prefills"] += 1
                health.count("admissions")
                active[slot] = rid
                admit_seq[slot] = seq_counter
                seq_counter += 1
                if rid in resume_prefix:
                    pre = resume_prefix.pop(rid)
                    generated[rid] = [pre[0]]
                    replay[rid] = pre[1:]
                    first = pre[0]
                    health.count("resumes")
                    health.count("resumed_tokens_replayed", len(pre) - 1)
                    health.event("resume", step, rid=rid, slot=slot,
                                 prefix_tokens=len(pre))
                else:
                    admit_step0[rid] = step
                    admit_t0[rid] = time.perf_counter()
                    with trace.span("sched.first_token", rid=rid):
                        t1, ok1 = select(last1, [(rid, 0)])
                        first, ok = torch.stack(
                            [t1[0], ok1[0].to(t1.dtype)]).tolist()
                    if not ok:
                        del active[slot]
                        failed[rid] = []
                        free_slot(slot)
                        idle.insert(0, slot)
                        health.count("nan_retired")
                        health.event("nan_retired", step, rid=rid, slot=slot,
                                     where="prefill")
                        continue
                    generated[rid] = [first]
                tokens[slot] = first
                if verbose:
                    print(f"[serve] step {step}: admitted request {rid} "
                          f"into slot {slot}", flush=True)

            if not active:
                # stalled (every slot preempted or waiting on the pool): no
                # decode this step
                it.end()
                step += 1
                if queue:
                    continue
                break

            # ---- decode one token per slot ------------------------------
            ts = time.perf_counter()
            dec = (trace.span("engine.decode", start=ts,
                              rids=[active[s] for s in sorted(active)])
                   if trace.enabled() else trace.OFF)
            logits, cache = engine.decode(tokens, cache)
            dec.end()
            logits = inj.corrupt_logits(step, logits)
            rows: List = [None] * slots
            for slot, rid in active.items():
                rows[slot] = (rid, len(generated[rid]))
            read = trace.span("sched.sample_read")
            toks, okv = select(logits, rows)
            # tokens and the finite guard in one host read
            tok_host, ok_host = torch.stack(
                [toks, okv.to(toks.dtype)]).cpu().numpy()
            t_read = time.perf_counter()
            read.end(t_read)
            stats["step_s"].append(t_read - ts)
            stats["decode_steps"] += 1
            tokens = toks

            for slot in sorted(active):
                rid = active[slot]
                if not ok_host[slot]:
                    # non-finite logits: retire the request, keep the batch
                    retire(slot, failed)
                    health.count("nan_retired")
                    health.event("nan_retired", step, rid=rid, slot=slot,
                                 where="decode")
                    continue
                if replay.get(rid):
                    nxt = replay[rid].pop(0)
                    if not replay[rid]:
                        del replay[rid]
                    if nxt != int(tok_host[slot]):
                        # replay re-derives the recorded token (greedy by
                        # determinism, sampled by count-addressed keys);
                        # the splice is the safety net, and counted
                        tokens[slot] = nxt
                        health.count("replay_splices")
                else:
                    nxt = int(tok_host[slot])
                generated[rid].append(nxt)
                if len(generated[rid]) >= gens[rid]:
                    retire(slot, finished)
                elif ((deadline_steps is not None
                       and step - admit_step0[rid] + 1 >= deadline_steps)
                      or (deadline_ms is not None
                          and (time.perf_counter() - admit_t0[rid]) * 1e3
                          >= deadline_ms)):
                    retire(slot, expired)
                    health.count("deadline_cancelled")
                    health.event("deadline", step, rid=rid, slot=slot,
                                 tokens=len(expired[rid]))
            t_end = time.perf_counter()
            watchdog.observe(
                step, t_end - ts_iter,
                expect_slow=(stats["slot_prefills"] != prefills0
                             or health.counters["preemptions"] != preempts0))
            it.end(t_end)
            step += 1

        engine.finalize(health, inj)
        stats["leaked_blocks"] = engine.leaked()
        stats["finished"] = finished
        stats["expired"] = expired
        stats["failed"] = failed
        stats["preemptions"] = health.counters["preemptions"]
        stats["resumes"] = health.counters["resumes"]
        stats["health"] = health.to_dict()
        stats["health"]["straggler_summary"] = watchdog.summary()
        stats["kv_bytes_per_step"] = engine.kv_bytes_per_step(gens)
        stats["warmup_prefills"] = engine.warmup_prefills if warm else 0
        stats["warmup_decode_steps"] = engine.warmup_decodes if warm else 0
        return finalize_stats(stats, finished, t0)

    return best_of(_run, repeats)


def run_speculative(params, cfg, prompts: List[np.ndarray], *, slots: int,
                    gen: int, gamma: int = 4, draft=None, block_k: int = 32,
                    max_len: Optional[int] = None,
                    gens: Optional[Sequence[int]] = None,
                    pool_blocks: Optional[int] = None,
                    preempt_policy: str = "newest",
                    deadline_steps: Optional[int] = None,
                    fault_plan: Optional[faults_mod.FaultPlan] = None,
                    warmup: bool = False, repeats: int = 1,
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
    ``gamma``, ``finished``, ``expired`` and ``failed`` (request id ->
    tokens), ``health`` and ``kv_bytes_per_step``.
    """
    self_draft = draft is None
    draft_params, dcfg = draft if draft is not None else (params, cfg)
    for c in (cfg, dcfg):
        if c.family not in ("dense", "moe"):
            raise ValueError(
                f"speculative serving of family {c.family!r}: speculation "
                f"is decoder-only (dense and MoE), as in the reference")
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError("the drafter must share the target's vocab")
    _check_policy(preempt_policy)
    requests = len(prompts)
    slots = min(slots, requests)
    gens = list(gens) if gens is not None else [gen] * requests
    if len(gens) != requests:
        raise ValueError(f"{len(gens)} gens for {requests} prompts")
    if max_len is None:
        # +gamma: the cache briefly holds the unaccepted draft tail before
        # the post-verify truncation
        max_len = max(len(p) for p in prompts) + max(gens) + gamma + 8
    bps = paged_kv.blocks_per_seq(max_len, block_k)
    if pool_blocks is not None and pool_blocks < 1 + bps:
        raise ValueError(
            f"pool_blocks={pool_blocks} cannot hold one sequence: need "
            f">= 1 + {bps} (trash + blocks_per_seq(max_len={max_len}))")
    pool_size = pool_blocks if pool_blocks is not None else 1 + slots * bps
    device = L.param_device(params)

    params = T.cast_for_serving(params, cfg)
    draft_params = (params if self_draft
                    else T.cast_for_serving(draft_params, dcfg))

    def prefill_steps(c):        # keyed by whether the admission calibrates
        return {cal: st.make_paged_prefill_step(c, calibrate=cal)
                for cal in (True, False)}

    # (params, prefill steps) of every pool, target first
    models = [(params, prefill_steps(cfg))] + (
        [] if self_draft else [(draft_params, prefill_steps(dcfg))])
    draft_loop = st.make_draft_loop(dcfg, gamma)
    verify_step = st.make_verify_step(cfg)

    def new_pool(c):
        return (engines_base.PoolManager(paged_kv.BlockAllocator(pool_size),
                                         bps, block_k),
                T.make_paged_cache(c, slots, max_len, block_k=block_k,
                                   num_blocks=pool_size, device=device))

    def new_pools():
        return [new_pool(cfg)] + ([] if self_draft else [new_pool(dcfg)])

    def admit_row(pg, slot, s_len):
        """Allocate a slot's admission coverage, prompt + gamma; its table
        row on the device."""
        return torch.as_tensor(pg.admit_row(slot, s_len + gamma)[None],
                               device=device)

    def select_targets(vlogits):
        """Argmax and the finite guard: a non-finite value anywhere in a
        slot's verify logits retires that slot."""
        return (torch.argmax(vlogits, dim=-1),
                torch.isfinite(vlogits).all(dim=-1).all(dim=-1))

    def draft_round(pools, pending, cur_lens):
        """One draft burst and the verify step over it."""
        cache = pools[0][1]
        if self_draft:
            drafts, _ = draft_loop(params, pending, cache)
            # length-only rewind: verify overwrites the draft K/V rows
            paged_kv.truncate_lengths(cache, torch.as_tensor(cur_lens,
                                                             device=device))
        else:
            drafts, _ = draft_loop(draft_params, pending, pools[1][1])
        verify_in = torch.cat([pending[:, None], drafts[:, :-1]], dim=1)
        vlogits, _ = verify_step(params, verify_in, cache)
        return drafts, vlogits

    if warmup:
        # one throwaway round on scratch pools of the same size: builds the
        # kernels and warms the GEMM shapes before the clock starts
        w_pools = new_pools()
        prompt = torch.as_tensor(prompts[0], dtype=torch.int64,
                                 device=device)[None]
        s_len = len(prompts[0])
        sid = torch.zeros((1,), dtype=torch.int32, device=device)
        last1 = []
        for (pg, c), (p, pf) in zip(w_pools, models):
            row = admit_row(pg, 0, s_len)
            pf[True](p, prompt, c, sid, row)
            last1.append(pf[False](p, prompt, c, sid, row)[0])
        w_lens = np.zeros((slots,), np.int32)
        w_lens[0] = s_len
        pending = torch.argmax(last1[0][0]).expand(slots).contiguous()
        _, vlogits = draft_round(w_pools, pending, w_lens)
        select_targets(vlogits)[1].cpu()
        for pg, c in w_pools:
            pg.release(0)
            paged_kv.release_slot(c, 0)

    def _run() -> Dict:
        # (pager, cache) of every pool a slot holds blocks in, target first
        pools = new_pools()
        pager = pools[0][0]
        d_pager = None if self_draft else pools[1][0]
        health = ServeHealth()
        inj = faults_mod.FaultInjector(fault_plan, health)
        watchdog = _watchdog(health)
        stats: Dict = {"slot_prefills": 0, "draft_steps": 0,
                       "verify_steps": 0, "drafts_proposed": 0,
                       "drafts_accepted": 0, "gamma": gamma, "step_s": []}
        queue = deque(range(requests))
        generated: Dict[int, List[int]] = {}
        finished: Dict[int, List[int]] = {}
        expired: Dict[int, List[int]] = {}
        failed: Dict[int, List[int]] = {}
        resume_prefix: Dict[int, List[int]] = {}
        expect: Dict[int, List[int]] = {}       # recorded prefix, re-asserted
        admit_step0: Dict[int, int] = {}
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

        def retire(slot, into: Dict[int, List[int]]):
            rid = active.pop(slot)
            into[rid] = generated.pop(rid)
            expect.pop(rid, None)
            free_slot(slot)

        def preempt(vslot, *, reason):
            rid = active.pop(vslot)
            pre = resume_prefix[rid] = generated.pop(rid)
            expect.pop(rid, None)
            free_slot(vslot)
            queue.appendleft(rid)
            health.count("preemptions")
            health.event("preempt", step, rid=rid, slot=vslot,
                         policy=preempt_policy, reason=reason,
                         prefix_tokens=len(pre))
            if verbose:
                print(f"[serve-spec] step {step}: preempted request {rid} "
                      f"(slot {vslot}, {reason})", flush=True)

        def park(slot):
            """Skip this slot's round and give back its own over-coverage
            tail (blocks past the accepted prefix) on every pool.  Its own
            tail only: another slot's gamma coverage is what that slot's
            draft writes into this round."""
            keep = int(cur_lens[slot])
            freed = 0
            for pg, c in pools:
                freed += pg.reclaim_tail(slot, keep)
                paged_kv.rollback_slot(c, slot, keep)
            parked.add(slot)
            health.count("spec_parks")
            health.event("park", step, slot=slot, rid=active[slot],
                         freed=freed)

        def grow(slot, upto, pg, c, tag) -> bool:
            """Cover ``upto`` positions for one slot on one pool; park, then
            preempt, under pressure.  False once the slot is out of the
            round."""
            while slot in active and pg.short(slot, upto) > 0:
                try:
                    start, ids = pg.grow(slot, pg.short(slot, upto))
                except paged_kv.BlockAllocationError as e:
                    health.event("pool_pressure", step, slot=slot, pool=tag,
                                 requested=e.requested, free=e.free,
                                 live=e.live, high_water=e.high_water)
                    if any(s != slot and s not in parked for s in active):
                        # another slot still speculates this round, so
                        # sitting it out cannot stall the whole batch
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
            ts_iter = time.perf_counter()
            prefills0 = stats["slot_prefills"]
            preempts0 = health.counters["preemptions"]
            inj.on_step(step)
            inj.squeeze_pool(step, pager.alloc)
            fslot = inj.force_preempt(step)
            if fslot is not None and fslot in active:
                preempt(fslot, reason="fault")

            # ---- growth: every slot needs len + gamma coverage ----------
            parked.clear()
            for slot in sorted(active):
                if slot not in active:
                    continue
                upto = int(cur_lens[slot]) + gamma
                if grow(slot, upto, *pools[0], "kv") and not self_draft:
                    grow(slot, upto, *pools[1], "draft_kv")

            # ---- admission: FIFO into idle slots, both pools at once -----
            idle = [s for s in range(slots) if s not in active]
            while queue and idle:
                rid = queue[0]
                s_len = len(prompts[rid])
                need = paged_kv.blocks_per_seq(s_len + gamma, block_k)
                if any(pg.alloc.free_count < need for pg, _ in pools):
                    health.count("admission_stalls")
                    health.event("admission_stall", step, rid=rid,
                                 need=need, free=pager.alloc.free_count)
                    break
                queue.popleft()
                slot = idle.pop(0)
                if calib_rid is None:
                    calib_rid = rid
                calibrate = rid == calib_rid
                sid = torch.tensor([slot], dtype=torch.int32, device=device)
                prompt = torch.as_tensor(prompts[rid], dtype=torch.int64,
                                         device=device)[None]
                last1 = [pf[calibrate](p, prompt, c, sid, admit_row(pg, slot,
                                                                   s_len))[0]
                         for (pg, c), (p, pf) in zip(pools, models)][0]
                stats["slot_prefills"] += len(pools)
                health.count("admissions")
                active[slot] = rid
                admit_seq[slot] = seq_counter
                seq_counter += 1
                first, ok = torch.stack(
                    [torch.argmax(last1[0]),
                     torch.isfinite(last1[0]).all().to(torch.int64)]).tolist()
                if not ok:
                    del active[slot]
                    failed[rid] = []
                    free_slot(slot)
                    idle.insert(0, slot)
                    health.count("nan_retired")
                    health.event("nan_retired", step, rid=rid, slot=slot,
                                 where="prefill")
                    continue
                if rid in resume_prefix:
                    pre = resume_prefix.pop(rid)
                    if first != pre[0]:
                        raise RuntimeError(
                            f"resume divergence for request {rid}: "
                            f"re-prefill token {first} != recorded {pre[0]}")
                    expect[rid] = pre
                    health.count("resumes")
                    health.count("resumed_tokens_replayed", len(pre) - 1)
                    health.event("resume", step, rid=rid, slot=slot,
                                 prefix_tokens=len(pre))
                else:
                    admit_step0[rid] = step
                generated[rid] = [first]
                pend_h[slot] = first
                cur_lens[slot] = s_len
                if verbose:
                    print(f"[serve-spec] step {step}: admitted request {rid} "
                          f"into slot {slot}", flush=True)

            if not active:
                step += 1
                continue

            # ---- one draft -> verify -> accept round ---------------------
            pending = torch.as_tensor(pend_h, device=device)
            ts = time.perf_counter()
            drafts, vlogits = draft_round(pools, pending, cur_lens)
            vlogits = inj.corrupt_logits(step, vlogits)
            targets, okv = select_targets(vlogits)
            # drafts, targets and the finite guard in one host read
            host = torch.cat([drafts, targets, okv[:, None].to(drafts.dtype)],
                             dim=1).cpu().numpy()
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
                    # sat the round out: nothing emitted, the prefix stays;
                    # its draft row read through trashed entries, so its
                    # discarded logits are exempt from the finite guard
                    new_lens[slot] = cur_lens[slot]
                    continue
                if not ok_h[slot]:
                    retire(slot, failed)
                    health.count("nan_retired")
                    health.event("nan_retired", step, rid=rid, slot=slot,
                                 where="verify")
                    continue
                k = 0
                while k < gamma and drafts_h[slot, k] == targets_h[slot, k]:
                    k += 1
                emit = [int(x) for x in drafts_h[slot, :k]]
                if k < gamma:
                    emit.append(int(targets_h[slot, k]))  # correction token
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
                        raise RuntimeError(f"resume divergence for request "
                                           f"{rid} at token {at}")
                    if len(got) >= len(want):
                        del expect[rid]
                if len(generated[rid]) >= gens[rid]:
                    retiring.append(slot)
                else:
                    new_lens[slot] = (len(prompts[rid]) + len(generated[rid])
                                      - 1)

            # rewind to the accepted prefixes in one shot; retiring and idle
            # slots truncate to zero
            lens_dev = torch.as_tensor(new_lens, device=device)
            for _, c in pools:
                paged_kv.truncate_lengths(c, lens_dev)
            cur_lens[:] = new_lens
            for slot in retiring:
                retire(slot, finished)

            if deadline_steps is not None:
                for slot in sorted(active):
                    rid = active[slot]
                    if step - admit_step0[rid] + 1 >= deadline_steps:
                        retire(slot, expired)
                        health.count("deadline_cancelled")
                        health.event("deadline", step, rid=rid, slot=slot,
                                     tokens=len(expired[rid]))
            watchdog.observe(
                step, time.perf_counter() - ts_iter,
                expect_slow=(stats["slot_prefills"] != prefills0
                             or health.counters["preemptions"] != preempts0))
            step += 1

        inj.drain(pager.alloc)
        for (pg, _), tag in zip(pools, ("kv", "draft_kv")):
            health.pool(tag, pg.alloc)
        stats["leaked_blocks"] = sum(pg.alloc.live_count for pg, _ in pools)
        stats["finished"] = finished
        stats["expired"] = expired
        stats["failed"] = failed
        for name in ("preemptions", "resumes", "spec_parks",
                     "admission_stalls"):
            stats[name] = health.counters.get(name, 0)
        stats["health"] = health.to_dict()
        stats["health"]["straggler_summary"] = watchdog.summary()
        stats["accept_rate"] = (stats["drafts_accepted"]
                                / max(stats["drafts_proposed"], 1))
        emitted = sum(len(v) for v in finished.values()) - len(finished)
        stats["tokens_per_verify"] = emitted / max(stats["verify_steps"], 1)
        mean_gen = sum(gens) // (2 * len(gens))
        mean_blocks = paged_kv.blocks_per_seq(len(prompts[0]) + mean_gen,
                                              block_k)
        stats["kv_bytes_per_step"] = (2 * cfg.n_layers * slots
                                      * cfg.n_kv_heads * mean_blocks
                                      * block_k * cfg.hd)
        return finalize_stats(stats, finished, t0)

    return best_of(_run, repeats)
