"""The one traffic generator: a mix's parameters (``bench/traffic/*.json``)
and a seed in, the request list out.

A mix is a closed loop of ``clients`` clients, one per serving slot: a
client sends its next request when the last token of its previous one has
reached the host.  The lengths are the mix's own and the same for every
seed, so that every run serves the same work: each block of ``block``
requests holds the prompt lengths at the quantiles ``(i + 0.5) / block`` of
``prompt_len``'s distribution and, paired by an independent permutation,
the generation lengths at the same quantiles of ``gen_len``'s, each block
in an order drawn from the mix's ``lengths_seed``.  The clients' first
requests, admitted before the window opens, come before the blocks:
prompts at ``clients`` quantiles, and the generation lengths still left at
a random moment of a steady stream (:func:`residual`), so that the window
opens on the steady state and not on every client starting at once.
The run's seed draws the token ids and the order of the first requests
among the slots, which changes no work: all are admitted before the
window, and a slot's number costs nothing.
Request 0, the one that calibrates the int8 KV pool's scales and the one
the serving warm-up runs, is the longest of the first requests' prompts.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np


def quantile(dist: Dict, u: np.ndarray) -> np.ndarray:
    """Whole lengths at the quantiles ``u`` of ``dist``: ``uniform`` or
    ``loguniform`` over ``[lo, hi]`` inclusive."""
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"length distribution {dist['dist']!r}")
    return np.clip(np.round(x), lo, hi).astype(np.int64)


def residual(gens: np.ndarray, n: int) -> np.ndarray:
    """``n`` stratified quantiles of the tokens a request still has to
    generate, seen at a random moment of a steady stream of requests with
    the generation lengths ``gens``: each length weighted by itself, a
    uniform point of it (``1..g`` tokens left)."""
    left = np.sort(np.concatenate([np.arange(1, x + 1) for x in gens]))
    return left[((np.arange(n) + 0.5) / n * len(left)).astype(np.int64)]


def lengths(mix: Dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(prompt lengths, generation lengths) of the mix's ``requests``: the
    clients' first requests, then whole blocks."""
    rng = np.random.default_rng(int(mix["lengths_seed"]))
    k, c = int(mix["block"]), int(mix["clients"])
    u = (np.arange(k) + 0.5) / k
    p_base, g_base = quantile(mix["prompt_len"], u), quantile(mix["gen_len"], u)
    p0 = np.sort(quantile(mix["prompt_len"], (np.arange(c) + 0.5) / c))[::-1]
    g0 = rng.permutation(residual(g_base, c))
    n_blocks = -(-(int(mix["requests"]) - c) // k)
    p = np.concatenate([p0] + [rng.permutation(p_base) for _ in range(n_blocks)])
    g = np.concatenate([g0] + [rng.permutation(g_base) for _ in range(n_blocks)])
    slots = np.concatenate([[0], 1 + np.random.default_rng(seed).permutation(c - 1)])
    p[:c], g[:c] = p[slots], g[slots]
    return p[:mix["requests"]], g[:mix["requests"]]


def make_requests(mix: Dict, seed: int, vocab_size: int
                  ) -> Tuple[List[np.ndarray], List[int]]:
    """The prompts (int64 token ids) and generation lengths of the mix."""
    if mix["loop"] != "closed":
        raise ValueError(f"traffic loop {mix['loop']!r}: the scheduler takes "
                         f"no arrival times, so only a closed loop is served")
    p, g = lengths(mix, seed)
    rng = np.random.default_rng([seed, 1])
    ids = rng.integers(0, vocab_size, size=int(p.sum()), dtype=np.int64)
    prompts = np.split(ids, np.cumsum(p)[:-1])
    return prompts, [int(x) for x in g]


def max_len(mix: Dict) -> int:
    """The longest sequence a request of the mix reaches."""
    return int(mix["prompt_len"]["hi"]) + int(mix["gen_len"]["hi"])
