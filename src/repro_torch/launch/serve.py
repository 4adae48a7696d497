"""Continuous-batching int8 serving (port of ``repro/launch/serve.py``:
``make_engine``, ``serve_paged``, ``serve_dense``, ``make_self_draft``,
``serve_speculative``, the ``serve`` dispatcher and the CLI, for every
family of the reference: every dense config of the registry
(TinyLlama-1.1B, OLMo-1B, Mistral-NeMo-12B, Chameleon-34B,
DeepSeek-Coder-33B, DeepSeek-67B), and DeepSeekMoE-16B and Mixtral-8x22B
through the same paged engine and speculative loop (the layer-prefix
drafter stays dense-only); Falcon-Mamba-7B through the SSM engine's int8
state slabs (``--cache dense``: the float state in the dense cache);
Zamba2-2.7B, the hybrid, through the dense cache only (as in the
reference, no engine pages it); SeamlessM4T-medium through the
encoder-decoder engine, whose encoder cross K/V live in a write-once
region carved out of the same pool (``frames`` carries each request's
encoder input; it is served paged, plainly or composed, never
speculatively or through the dense cache).  Speculation is for the dense
and MoE families, as in the reference.

Paged (the default): every admission is a per-slot prefill that allocates
only the blocks its prompt needs; a slot grows one block at a time as it
crosses block boundaries, and retirement returns its blocks.  The prefill
attention runs the split-softmax prefill kernel and every decode step the
fused paged decode kernel (``--fused off``: the composed one), on the card;
on the CPU their plain versions.  ``--draft`` serves speculatively: drafter
decode steps, then one verify step of the target through the paged verify
kernel.  ``--cache dense`` is the baseline the paged pool is measured
against: one ``(slots, max_len)`` int8 cache, and every retirement
re-prefills the whole batch; its decode steps run the dense decode kernels.

``--pool-blocks`` sizes the pool below ``slots * blocks_per_seq`` to
over-commit it.  When growth or admission then runs out of blocks, the
scheduler preempts a victim (``--preempt-policy newest | longest``): its
blocks are freed and the request is re-queued with its generated prefix.
On re-admission the prompt is re-prefilled and the prefix replayed through
the ordinary decode batch, so its tokens equal those of a run that was
never preempted, greedy or sampled (sampling keys are addressed by request
and draw count, ``scheduler.RequestKeys``).

The same loop carries the operational guards: ``--deadline-steps N`` and
``--deadline-ms MS`` expire a request (``stats["expired"]``), the latter
also making admission earliest-deadline-first; a finite guard in the token
selector retires a request whose logits go NaN or Inf (``stats["failed"]``);
every step is timed by a straggler watchdog, and every degradation lands in
a ``ServeHealth`` record written by ``--metrics-json``.  Faults are injected
from the environment (``launch/faults.py``):

    REPRO_FAULT_EXHAUST=S[:H]    steal all free blocks at step S, hold H steps
    REPRO_FAULT_DELAY=S:SEC      sleep SEC before step S (trips the watchdog)
    REPRO_FAULT_NAN=S[:SLOT]     NaN one slot's logits at step S
    REPRO_FAULT_PREEMPT=S[:SLOT] force-preempt one slot at step S
    REPRO_FAULT_SEED=N           recorded in the plan

    python -m repro_torch.launch.serve --arch tinyllama_1p1b
    python -m repro_torch.launch.serve --arch tinyllama_1p1b --draft self:4
    python -m repro_torch.launch.serve --arch tinyllama_1p1b --cache dense
    python -m repro_torch.launch.serve --arch mistral_nemo_12b
    python -m repro_torch.launch.serve --arch olmo_1b --smoke --device cpu
    python -m repro_torch.launch.serve --arch deepseek_moe_16b --draft self
    python -m repro_torch.launch.serve --arch mixtral_8x22b --smoke \\
        --device cpu
    python -m repro_torch.launch.serve --arch seamless_m4t_medium --smoke \\
        --device cpu --requests 6 --slots 3 --prompt-len 12 --gen 10
    python -m repro_torch.launch.serve --arch falcon_mamba_7b --smoke \\
        --device cpu --requests 6 --slots 3 --prompt-len 14 --gen 10
    python -m repro_torch.launch.serve --arch zamba2_2p7b --smoke \\
        --device cpu --cache dense
    python -m repro_torch.launch.serve --arch tinyllama_1p1b --smoke \\
        --device cpu --requests 8 --slots 4 --prompt-len 32 --gen 24 \\
        --pool-blocks 12 --temperature 0.8 --top-p 0.95 \\
        --deadline-steps 200 --metrics-json health.json
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import faults as faults_mod
from repro_torch.launch import scheduler as sched
from repro_torch.launch import steps as st
from repro_torch.launch.engines import (EncDecEngine, PagedKVEngine,
                                       SSMStateEngine)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def make_engine(params, cfg, prompts: List[np.ndarray], *, slots: int,
                max_len: int, block_k: int = 32,
                pool_blocks: Optional[int] = None,
                frames: Optional[List[np.ndarray]] = None):
    """Family -> cache engine; the only family switch in serving.
    ``frames`` are the encdec family's per-request encoder inputs, one
    ``(S_enc, d_model)`` array each."""
    if cfg.family in ("dense", "moe"):
        return PagedKVEngine(params, cfg, prompts, slots=slots,
                             max_len=max_len, block_k=block_k,
                             pool_blocks=pool_blocks)
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("encdec serving needs per-request encoder "
                             "frames (frames=[(S_enc, d_model) arrays])")
        return EncDecEngine(params, cfg, prompts, frames=frames, slots=slots,
                            max_len=max_len, block_k=block_k,
                            pool_blocks=pool_blocks)
    if cfg.family == "ssm":
        return SSMStateEngine(params, cfg, prompts, slots=slots,
                              max_len=max_len, block_k=block_k,
                              pool_blocks=pool_blocks)
    raise ValueError(f"no cache engine for family {cfg.family!r}")


def serve_paged(params, cfg, prompts: List[np.ndarray], *, slots: int,
                gen: int, block_k: int = 32, max_len: Optional[int] = None,
                gens: Optional[Sequence[int]] = None,
                temperature: float = 0.0, top_p: float = 1.0,
                sample_seed: int = 0,
                pool_blocks: Optional[int] = None,
                preempt_policy: str = "newest",
                deadline_steps: Optional[int] = None,
                deadline_ms: Optional[float] = None,
                fault_plan: Optional[faults_mod.FaultPlan] = None,
                frames: Optional[List[np.ndarray]] = None,
                warmup: bool = False, repeats: int = 1,
                verbose: bool = False) -> Dict:
    """Demand-paged serving on the device ``params`` live on; returns the
    scheduler's stats dict (see
    :func:`repro_torch.launch.scheduler.run_schedule`, which also documents
    the sampling, preemption, deadline, fault, warm-up and repeat options).

    ``gens`` optionally staggers per-request generation lengths (churn).
    ``pool_blocks`` sizes the pool below the full ``1 + slots *
    blocks_per_seq(max_len)`` reservation; exhaustion preempts a
    ``preempt_policy`` victim and resumes it later with the same tokens.
    ``frames`` carries the encdec family's per-request encoder inputs.
    """
    requests = len(prompts)
    slots = min(slots, requests)
    gens = list(gens) if gens is not None else [gen] * requests
    if max_len is None:
        max_len = max(len(p) for p in prompts) + max(gens) + 8
    engine = make_engine(params, cfg, prompts, slots=slots, max_len=max_len,
                         block_k=block_k, pool_blocks=pool_blocks,
                         frames=frames)
    return sched.run_schedule(
        engine, prompts, gens=gens, temperature=temperature, top_p=top_p,
        sample_seed=sample_seed, preempt_policy=preempt_policy,
        deadline_steps=deadline_steps, deadline_ms=deadline_ms,
        fault_plan=fault_plan, warmup=warmup, repeats=repeats,
        verbose=verbose)


def serve_dense(params, cfg, prompts: List[np.ndarray], *, slots: int,
                gen: int, max_len: Optional[int] = None,
                gens: Optional[Sequence[int]] = None,
                temperature: float = 0.0, top_p: float = 1.0,
                sample_seed: int = 0,
                warmup: bool = False, repeats: int = 1,
                verbose: bool = False) -> Dict:
    """The pre-paged baseline scheduler: one dense ``(slots, max_len)`` int8
    cache, and every retirement re-prefills the *entire* batch (prompt +
    generated-so-far of each in-flight slot, the newly admitted request's
    prompt, zero rows of length 1 for idle slots) into a fresh cache,
    recalibrating its scales batch-wide.  Tokens are selected as in
    :func:`serve_paged`; ``warmup`` runs each step once before the clock,
    ``repeats`` keeps the fastest of that many runs.

    Returns the stats of :func:`repro_torch.launch.scheduler.finalize_stats`
    with ``batch_prefills``, ``slot_prefills`` (0), ``decode_steps``,
    ``kv_bytes_per_step``, ``leaked_blocks`` (0) and ``finished``.

    Every cache write stays inside ``max_len`` at its default: a live slot
    writes at most at ``prompt_len + gens - 2`` and an idle one at most
    ``max(gens)`` positions past its re-prefilled length 1.

    The decoder-only families only: its batches carry no encoder frames
    (the reference's ``serve_dense`` raises a ``KeyError`` on ``frames``
    for the encdec family at its first prefill).  Two faults of the
    reference are copied for the SSM and hybrid families, so that their
    tokens compare (ROADMAP queue 3): a re-prefilled row shorter than the
    re-prefill width continues from the state after its zero padding (see
    ``transformer.prefill``), and ``kv_bytes_per_step`` counts
    ``n_layers`` attention layers of ``n_kv_heads x hd`` whatever the
    family.
    """
    if cfg.family == "encdec":
        raise ValueError("serve_dense serves the decoder-only families; the "
                         "encdec family serves paged (its batches need "
                         "encoder frames)")
    requests = len(prompts)
    prompt_len = len(prompts[0])
    if any(len(p) != prompt_len for p in prompts):
        raise ValueError("the dense scheduler takes prompts of one length")
    slots = min(slots, requests)
    gens = list(gens) if gens is not None else [gen] * requests
    if len(gens) != requests:
        raise ValueError(f"{len(gens)} gens for {requests} prompts")
    if max_len is None:
        max_len = prompt_len + max(gens) + 8
    seq_pad = prompt_len + max(gens)    # fixed re-prefill width
    device = L.param_device(params)
    params = T.cast_for_serving(params, cfg)
    prefill_step = st.make_prefill_step(cfg, max_len)
    decode_step = st.make_decode_step(cfg)
    sampler = sched.make_sampler(temperature, top_p, cfg.vocab_size)

    def reprefill_step(seqs, lens):
        return T.prefill(params, seqs, cfg,
                         T.make_cache(cfg, slots, max_len, device=device),
                         valid_len=lens)

    if warmup:
        base = [sched.RequestKeys(sample_seed).base] * slots
        w_last, _ = prefill_step(params, {"tokens": torch.as_tensor(
            np.stack([prompts[0]] * slots), device=device)})
        _, w_cache = reprefill_step(
            torch.zeros((slots, seq_pad), dtype=torch.int32, device=device),
            torch.full((slots,), prompt_len, dtype=torch.int32,
                       device=device))
        w_tok, _ = sampler(w_last, base)
        w_out, _ = decode_step(params, w_tok, w_cache)
        sampler(w_out, base)[0].cpu()

    def _run() -> Dict:
        stats: Dict = {"batch_prefills": 0, "slot_prefills": 0,
                       "decode_steps": 0, "step_s": []}
        queue = list(range(requests))
        generated: Dict[int, List[int]] = {}
        finished: Dict[int, List[int]] = {}
        active: Dict[int, int] = {}
        keys = sched.RequestKeys(sample_seed)

        def select(logits):
            """Tokens on the device and on the host, one host read."""
            ks = [keys.key(active[s], len(generated.get(active[s], [])))
                  if s in active else keys.base for s in range(slots)]
            toks, _ = sampler(logits, ks)
            return toks, toks.cpu().numpy()

        t0 = time.perf_counter()
        for slot in range(slots):
            active[slot] = queue.pop(0)
        prompts_arr = torch.as_tensor(
            np.stack([prompts[active[s]] for s in range(slots)]),
            device=device)
        last, cache = prefill_step(params, {"tokens": prompts_arr})
        stats["batch_prefills"] += 1
        tokens, tok_host = select(last)
        for slot in range(slots):
            generated[active[slot]] = [int(tok_host[slot])]

        while active:
            ts = time.perf_counter()
            logits, cache = decode_step(params, tokens, cache)
            tokens, tok_host = select(logits)
            stats["step_s"].append(time.perf_counter() - ts)
            stats["decode_steps"] += 1
            retired = False
            for slot in sorted(active):
                rid = active[slot]
                generated[rid].append(int(tok_host[slot]))
                if len(generated[rid]) >= gens[rid]:
                    finished[rid] = generated.pop(rid)
                    del active[slot]
                    retired = True
                    if queue:
                        active[slot] = queue.pop(0)
                        generated[active[slot]] = []
                        if verbose:
                            print(f"[serve-dense] step "
                                  f"{stats['decode_steps']}: admitted "
                                  f"request {active[slot]} into slot {slot}",
                                  flush=True)
            if retired and active:
                # admission (or plain retirement) = full-batch re-prefill,
                # the throughput collapse the paged scheduler removes
                seqs = np.zeros((slots, seq_pad), np.int32)
                lens = np.ones((slots,), np.int32)
                for slot, rid in active.items():
                    seq = np.concatenate([prompts[rid],
                                          np.asarray(generated[rid],
                                                     np.int32)])
                    seqs[slot, :len(seq)] = seq
                    lens[slot] = len(seq)
                last, cache = reprefill_step(
                    torch.as_tensor(seqs, device=device),
                    torch.as_tensor(lens, device=device))
                stats["batch_prefills"] += 1
                tokens, tok_host = select(last)
                for slot, rid in active.items():
                    generated[rid].append(int(tok_host[slot]))

        stats["leaked_blocks"] = 0
        stats["finished"] = finished
        stats["kv_bytes_per_step"] = (2 * cfg.n_layers * slots
                                      * cfg.n_kv_heads * max_len * cfg.hd)
        return sched.finalize_stats(stats, finished, t0)

    return sched.best_of(_run, repeats)


def make_self_draft(params, cfg, n_layers: Optional[int] = None):
    """A drafter ``(params, cfg)`` derived from the target without new
    weights: ``None`` is the target itself (self-speculation, acceptance 1
    where verify and decode agree), an integer keeps the first ``n_layers``
    decoder blocks and shares the embedding, final norm and head (a tied
    head is the shared embedding table)."""
    if n_layers is None:
        return params, cfg
    if cfg.family != "dense" or not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"a layer-prefix drafter takes 1..{cfg.n_layers} "
                         f"layers of a dense model, got {n_layers}")
    return (dict(params, layers=params["layers"][:n_layers]),
            cfg.replace(n_layers=n_layers))


def serve_speculative(params, cfg, prompts: List[np.ndarray], *, slots: int,
                      gen: int, gamma: int = 4, draft=None,
                      block_k: int = 32, max_len: Optional[int] = None,
                      gens: Optional[Sequence[int]] = None,
                      pool_blocks: Optional[int] = None,
                      preempt_policy: str = "newest",
                      deadline_steps: Optional[int] = None,
                      fault_plan: Optional[faults_mod.FaultPlan] = None,
                      warmup: bool = False, repeats: int = 1,
                      verbose: bool = False) -> Dict:
    """Greedy speculative serving through the paged int8 pool.

    Each round the drafter proposes ``gamma`` tokens per slot (``gamma``
    decode steps), the target verifies them in one step whose T = gamma
    queries per slot take one verify launch per layer, and the longest
    agreeing prefix is accepted plus the target's correction token.  Caches
    are then truncated to the accepted prefix; the accepted tokens' K/V are
    already right because the target wrote them during verify.

    ``draft`` is a ``(draft_params, draft_cfg)`` pair, which gets its own
    pool kept in lockstep with the target's, or None: self-drafting shares
    the target's pool, the draft steps append at ``len .. len + gamma``, a
    length-only rewind returns to ``len``, and verify overwrites those
    positions before anything past ``len`` is read again.

    Each round needs coverage for ``len + gamma`` positions.  Under pool
    pressure a slot first parks for the round (gives back its own tail on
    every pool and emits nothing); only when every other slot is parked is
    a victim preempted (``preempt_policy``, see
    :func:`repro_torch.launch.scheduler.pick_victim`) and later resumed by
    re-prefill, its recorded prefix asserted token by token.
    ``deadline_steps``, ``fault_plan`` (a NaN in a slot's verify logits
    retires that slot only), ``warmup`` and ``repeats`` act as in
    :func:`serve_paged`; a wall-clock deadline is not wired into this loop,
    as in the reference.

    Emitted tokens are the plain greedy tokens for any drafter wherever
    ``verify_step``'s logits equal the decode step's: every accepted token
    and every correction is the target's own argmax.  Returns the stats of
    :func:`repro_torch.launch.scheduler.run_speculative`.
    """
    return sched.run_speculative(
        params, cfg, prompts, slots=slots, gen=gen, gamma=gamma, draft=draft,
        block_k=block_k, max_len=max_len, gens=gens, pool_blocks=pool_blocks,
        preempt_policy=preempt_policy, deadline_steps=deadline_steps,
        fault_plan=fault_plan, warmup=warmup, repeats=repeats,
        verbose=verbose)


def serve(params, cfg, prompts: List[np.ndarray], *, slots: int, gen: int,
          cache_kind: str = "paged", block_k: int = 32,
          max_len: Optional[int] = None,
          gens: Optional[Sequence[int]] = None,
          gamma: int = 4, draft=None,
          temperature: float = 0.0, top_p: float = 1.0,
          sample_seed: int = 0,
          pool_blocks: Optional[int] = None,
          preempt_policy: str = "newest",
          deadline_steps: Optional[int] = None,
          deadline_ms: Optional[float] = None,
          fault_plan: Optional[faults_mod.FaultPlan] = None,
          frames: Optional[List[np.ndarray]] = None,
          metrics_json: Optional[str] = None,
          warmup: bool = False, repeats: int = 1,
          verbose: bool = False) -> Dict:
    """Dispatch on the cache layout and the speculative mode: plain paged
    serving, dense serving (``cache_kind="dense"``, see
    :func:`serve_dense`), or speculative serving when ``draft`` is given:
    ``"self"`` or a ``(draft_params, draft_cfg)`` pair.  As in the
    reference, speculation is greedy and paged only and takes no
    ``deadline_ms``, and the pool, deadline and fault options are paged-path
    options; ``frames`` carries the encdec family's encoder inputs (paged
    serving only).  ``metrics_json`` writes the run's health record and a
    summary of the run as one JSON document."""
    if cache_kind not in ("paged", "dense"):
        raise ValueError(f"cache_kind {cache_kind!r}: 'paged' or 'dense'")
    if draft is not None:
        if cache_kind != "paged":
            raise ValueError("speculative serving is paged-only")
        if temperature != 0.0:
            raise ValueError("speculative serving is greedy-only")
        if deadline_ms is not None:
            raise ValueError("deadline_ms is not wired into the speculative "
                             "loop")
        stats = serve_speculative(
            params, cfg, prompts, slots=slots, gen=gen, gamma=gamma,
            draft=None if draft == "self" else draft, block_k=block_k,
            max_len=max_len, gens=gens, pool_blocks=pool_blocks,
            preempt_policy=preempt_policy, deadline_steps=deadline_steps,
            fault_plan=fault_plan, warmup=warmup, repeats=repeats,
            verbose=verbose)
    elif cache_kind == "paged":
        stats = serve_paged(
            params, cfg, prompts, slots=slots, gen=gen, block_k=block_k,
            max_len=max_len, gens=gens, temperature=temperature,
            top_p=top_p, sample_seed=sample_seed, pool_blocks=pool_blocks,
            preempt_policy=preempt_policy, deadline_steps=deadline_steps,
            deadline_ms=deadline_ms, fault_plan=fault_plan, frames=frames,
            warmup=warmup, repeats=repeats, verbose=verbose)
    else:
        if pool_blocks is not None or deadline_steps is not None or (
                deadline_ms is not None) or (
                fault_plan is not None and fault_plan.armed):
            raise ValueError("pool_blocks / deadlines / faults are "
                             "paged-path features; --cache dense has no "
                             "block pool to squeeze")
        stats = serve_dense(params, cfg, prompts, slots=slots, gen=gen,
                            max_len=max_len, gens=gens,
                            temperature=temperature, top_p=top_p,
                            sample_seed=sample_seed, warmup=warmup,
                            repeats=repeats, verbose=verbose)
    if metrics_json:
        doc = dict(stats.get("health", {}))
        doc["run"] = {k: stats[k] for k in
                      ("served", "total_tokens", "tok_s", "wall_s",
                       "decode_steps", "leaked_blocks", "p50_step_ms",
                       "p99_step_ms") if k in stats}
        doc["run"]["expired"] = sorted(stats.get("expired", {}))
        doc["run"]["failed"] = sorted(stats.get("failed", {}))
        path = pathlib.Path(metrics_json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, indent=2, sort_keys=True))
        if verbose:
            print(f"[serve] health metrics -> {path}", flush=True)
    return stats


def main(argv=None) -> Dict:
    """Run the CLI; returns ``serve``'s stats."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama_1p1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--block-k", type=int, default=32)
    ap.add_argument("--cache", choices=("paged", "dense"), default="paged",
                    help="KV cache: the paged int8 block pool, or the dense "
                         "(slots, max_len) baseline whose admissions "
                         "re-prefill the whole batch")
    ap.add_argument("--fused", choices=("auto", "on", "off"), default="auto",
                    help="decode datapath: the fused kernel quantizes q "
                         "in-kernel (auto/on); off quantizes outside and "
                         "runs the composed kernel (same tokens)")
    ap.add_argument("--draft", default=None,
                    help="speculative drafter: 'self' (the target), "
                         "'self:N' (its first N layers) or an arch name "
                         "(random weights from seed + 1); greedy, paged")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft tokens per speculative round")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy (the default, "
                         "and required under --draft)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (with --temperature)")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="over-commit: size the KV block pool below the "
                         "full slots * blocks_per_seq reservation; pool "
                         "pressure preempts and resumes requests (same "
                         "tokens)")
    ap.add_argument("--preempt-policy", choices=("newest", "longest"),
                    default="newest",
                    help="victim under pool pressure: the most recently "
                         "admitted slot, or the most generation left")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="expire a request still unfinished this many "
                         "scheduler steps after its first admission")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="expire a request still unfinished this many ms "
                         "after its first admission; admission becomes "
                         "earliest-deadline-first")
    ap.add_argument("--metrics-json", default=None,
                    help="write the run's health record (preemptions, "
                         "stragglers, faults, pool occupancy) here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    def config(name):
        arch = get_arch(name)
        c = arch.smoke.replace(dtype="float32") if args.smoke else arch.config
        return c.replace(attn_fused=args.fused != "off")

    # weights drawn already cast for serving: the f32 masters of a full
    # width MoE would not fit beside them
    cfg = config(args.arch)
    params = st.init_params_fn(cfg)(seed=args.seed, device=args.device,
                                    serving=True)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len,
                            dtype=np.int32) for _ in range(args.requests)]
    frames = None
    if cfg.family == "encdec":
        # stand-ins for the speech frontend's frame embeddings, drawn after
        # the prompts from the same generator, one encoder length a run
        frames = [np.asarray(rng.normal(size=(args.prompt_len, cfg.d_model)),
                             np.float32) * 0.02
                  for _ in range(args.requests)]
    draft = args.draft
    if draft is not None and draft != "self":
        if draft.startswith("self:"):
            draft = make_self_draft(params, cfg, int(draft.split(":", 1)[1]))
        else:
            dcfg = config(draft)
            draft = (T.init_params(dcfg, seed=args.seed + 1,
                                   device=args.device, serving=True), dcfg)
    fault_plan = faults_mod.FaultPlan.from_env()
    stats = serve(params, cfg, prompts, slots=args.slots, gen=args.gen,
                  cache_kind=args.cache, block_k=args.block_k,
                  gamma=args.gamma, draft=draft,
                  temperature=args.temperature, top_p=args.top_p,
                  pool_blocks=args.pool_blocks,
                  preempt_policy=args.preempt_policy,
                  deadline_steps=args.deadline_steps,
                  deadline_ms=args.deadline_ms,
                  fault_plan=fault_plan if fault_plan.armed else None,
                  frames=frames, metrics_json=args.metrics_json,
                  verbose=True)
    mode = args.cache + ("+spec" if args.draft else "")
    steps = (f"{stats['verify_steps']} verify rounds" if args.draft
             else f"{stats['decode_steps']} decode steps")
    prefills = (f"{stats['batch_prefills']} batch prefills"
                if args.cache == "dense"
                else f"{stats['slot_prefills']} slot prefills")
    print(f"[{mode}:{cfg.family}:{args.device}] served {stats['served']} "
          f"requests, {stats['total_tokens']} tokens in "
          f"{stats['wall_s']:.2f}s ({stats['tok_s']:.1f} tok/s, {steps}, "
          f"{prefills}, p50/p99 step "
          f"{stats['p50_step_ms']:.1f}/{stats['p99_step_ms']:.1f} ms, "
          f"{stats['leaked_blocks']} leaked blocks)", flush=True)
    if "health" in stats:
        c = stats["health"]["counters"]
        print(f"  health: {c['preemptions']} preemptions, "
              f"{c['resumes']} resumes "
              f"({c['resumed_tokens_replayed']} tokens replayed), "
              f"{c['admission_stalls']} stalls, "
              f"{c['deadline_cancelled']} expired, "
              f"{c['nan_retired']} NaN-retired, "
              f"{c['faults_injected']} faults, "
              f"{len(stats['health']['stragglers'])} straggler steps",
              flush=True)
    if args.draft:
        print(f"  speculative: gamma={stats['gamma']} "
              f"accept_rate={stats['accept_rate']:.2f} "
              f"tokens_per_verify={stats['tokens_per_verify']:.2f} "
              f"({stats['verify_steps']} verify rounds, "
              f"{stats['spec_parks']} parks)", flush=True)
    for rid in sorted(stats["finished"]):
        print(f"  req {rid}: {stats['finished'][rid][:8]}...")
    return stats


if __name__ == "__main__":
    main()
