"""Continuous-batching int8 paged serving (port of
``repro/launch/serve.py``: ``serve_paged``, ``make_self_draft``,
``serve_speculative``, the ``serve`` dispatcher and the CLI for the dense
family).

Every admission is a per-slot prefill that allocates only the blocks its
prompt needs; a slot grows one block at a time as it crosses block
boundaries, and retirement returns its blocks.  The prefill attention runs
the split-softmax prefill kernel and every decode step the fused paged
decode kernel (``--fused off``: the composed one), on the card; on the CPU
their plain versions.  ``--draft`` serves speculatively: drafter decode
steps, then one verify step of the target through the paged verify kernel.

    python -m repro_torch.launch.serve --arch tinyllama_1p1b
    python -m repro_torch.launch.serve --arch tinyllama_1p1b --draft self:4
    python -m repro_torch.launch.serve --arch tinyllama_1p1b --smoke \\
        --device cpu --requests 8 --slots 4 --prompt-len 32 --gen 24 \\
        --draft self --gamma 3
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.launch import scheduler as sched
from repro_torch.launch.engines import PagedKVEngine
from repro_torch.models import transformer as T


def serve_paged(params, cfg, prompts: List[np.ndarray], *, slots: int,
                gen: int, block_k: int = 32,
                gens: Optional[Sequence[int]] = None,
                pool_blocks: Optional[int] = None,
                verbose: bool = False) -> Dict:
    """Demand-paged greedy serving on the device ``params`` live on;
    returns the scheduler's stats dict (see
    :func:`repro_torch.launch.scheduler.run_schedule`).

    ``gens`` optionally staggers per-request generation lengths (churn).
    ``pool_blocks`` sizes the pool below the full ``1 + slots *
    blocks_per_seq`` reservation; running out raises.
    """
    requests = len(prompts)
    slots = min(slots, requests)
    gens = list(gens) if gens is not None else [gen] * requests
    max_len = max(len(p) for p in prompts) + max(gens) + 8
    engine = PagedKVEngine(params, cfg, prompts, slots=slots, max_len=max_len,
                           block_k=block_k, pool_blocks=pool_blocks)
    return sched.run_schedule(engine, prompts, gens=gens, verbose=verbose)


def make_self_draft(params, cfg, n_layers: Optional[int] = None):
    """A drafter ``(params, cfg)`` derived from the target without new
    weights: ``None`` is the target itself (self-speculation, acceptance 1
    where verify and decode agree), an integer keeps the first ``n_layers``
    decoder blocks and shares the embedding, final norm and head."""
    if n_layers is None:
        return params, cfg
    if cfg.family != "dense" or not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"a layer-prefix drafter takes 1..{cfg.n_layers} "
                         f"layers of a dense model, got {n_layers}")
    return (dict(params, layers=params["layers"][:n_layers]),
            cfg.replace(n_layers=n_layers))


def serve_speculative(params, cfg, prompts: List[np.ndarray], *, slots: int,
                      gen: int, gamma: int = 4, draft=None,
                      block_k: int = 32,
                      gens: Optional[Sequence[int]] = None,
                      pool_blocks: Optional[int] = None,
                      preempt_policy: str = "newest",
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

    Emitted tokens are the plain greedy tokens for any drafter wherever
    ``verify_step``'s logits equal the decode step's: every accepted token
    and every correction is the target's own argmax.  Returns the stats of
    :func:`repro_torch.launch.scheduler.run_speculative`.
    """
    return sched.run_speculative(
        params, cfg, prompts, slots=slots, gen=gen, gamma=gamma, draft=draft,
        block_k=block_k, gens=gens, pool_blocks=pool_blocks,
        preempt_policy=preempt_policy, verbose=verbose)


def serve(params, cfg, prompts: List[np.ndarray], *, slots: int, gen: int,
          block_k: int = 32, gens: Optional[Sequence[int]] = None,
          gamma: int = 4, draft=None, pool_blocks: Optional[int] = None,
          verbose: bool = False) -> Dict:
    """Plain paged serving, or speculative serving when ``draft`` is given:
    ``"self"`` or a ``(draft_params, draft_cfg)`` pair.  Speculation is
    greedy and paged only, as in the reference."""
    if draft is None:
        return serve_paged(params, cfg, prompts, slots=slots, gen=gen,
                           block_k=block_k, gens=gens,
                           pool_blocks=pool_blocks, verbose=verbose)
    return serve_speculative(
        params, cfg, prompts, slots=slots, gen=gen, gamma=gamma,
        draft=None if draft == "self" else draft, block_k=block_k,
        gens=gens, pool_blocks=pool_blocks, verbose=verbose)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama_1p1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--block-k", type=int, default=32)
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
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="size the KV block pool below the full "
                         "slots * blocks_per_seq reservation (speculative "
                         "serving parks and preempts; plain raises)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    def config(name):
        arch = get_arch(name)
        c = arch.smoke.replace(dtype="float32") if args.smoke else arch.config
        return c.replace(attn_fused=args.fused != "off")

    cfg = config(args.arch)
    params = T.init_params(cfg, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len,
                            dtype=np.int32) for _ in range(args.requests)]
    draft = args.draft
    if draft is not None and draft != "self":
        if draft.startswith("self:"):
            draft = make_self_draft(params, cfg, int(draft.split(":", 1)[1]))
        else:
            dcfg = config(draft)
            draft = (T.init_params(dcfg, seed=args.seed + 1,
                                   device=args.device), dcfg)
    stats = serve(params, cfg, prompts, slots=args.slots, gen=args.gen,
                  block_k=args.block_k, gamma=args.gamma, draft=draft,
                  pool_blocks=args.pool_blocks, verbose=True)
    mode = "paged+spec" if args.draft else "paged"
    steps = (f"{stats['verify_steps']} verify rounds" if args.draft
             else f"{stats['decode_steps']} decode steps")
    print(f"[{mode}:{cfg.family}:{args.device}] served {stats['served']} "
          f"requests, {stats['total_tokens']} tokens in "
          f"{stats['wall_s']:.2f}s ({stats['tok_s']:.1f} tok/s, {steps}, "
          f"{stats['slot_prefills']} slot prefills, p50/p99 step "
          f"{stats['p50_step_ms']:.1f}/{stats['p99_step_ms']:.1f} ms, "
          f"{stats['leaked_blocks']} leaked blocks)", flush=True)
    if args.draft:
        print(f"  speculative: gamma={stats['gamma']} "
              f"accept_rate={stats['accept_rate']:.2f} "
              f"tokens_per_verify={stats['tokens_per_verify']:.2f} "
              f"({stats['verify_steps']} verify rounds, "
              f"{stats['preemptions']} preemptions, {stats['spec_parks']} "
              f"parks)", flush=True)
    for rid in sorted(stats["finished"]):
        print(f"  req {rid}: {stats['finished'][rid][:8]}...")


if __name__ == "__main__":
    main()
