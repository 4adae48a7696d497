"""Continuous-batching int8 paged serving (port of
``repro/launch/serve.py``: ``serve_paged`` and the CLI for the dense
family).

Every admission is a per-slot prefill that allocates only the blocks its
prompt needs; a slot grows one block at a time as it crosses block
boundaries, and retirement returns its blocks.  The prefill attention runs
the split-softmax prefill kernel and every decode step the fused paged
decode kernel, on the card; on the CPU their plain versions.

    python -m repro_torch.launch.serve --arch tinyllama_1p1b
    python -m repro_torch.launch.serve --arch tinyllama_1p1b --smoke \\
        --device cpu --requests 8 --slots 4 --prompt-len 32 --gen 24
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.config
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    params = T.init_params(cfg, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len,
                            dtype=np.int32) for _ in range(args.requests)]
    stats = serve_paged(params, cfg, prompts, slots=args.slots, gen=args.gen,
                        block_k=args.block_k, verbose=True)
    print(f"[paged:{cfg.family}:{args.device}] served {stats['served']} "
          f"requests, {stats['total_tokens']} tokens in "
          f"{stats['wall_s']:.2f}s ({stats['tok_s']:.1f} tok/s, "
          f"{stats['decode_steps']} decode steps, {stats['slot_prefills']} "
          f"slot prefills, p50/p99 step {stats['p50_step_ms']:.1f}/"
          f"{stats['p99_step_ms']:.1f} ms, {stats['leaked_blocks']} leaked "
          f"blocks)", flush=True)
    for rid in sorted(stats["finished"]):
        print(f"  req {rid}: {stats['finished'][rid][:8]}...")


if __name__ == "__main__":
    main()
