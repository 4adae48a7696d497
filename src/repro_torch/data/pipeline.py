"""Deterministic, stateless-seeded synthetic LM data (port of
``repro/data/pipeline.py``).

``batch_for_step`` is a pure function of ``(seed, step, host_index)``, so a
run restarted from a checkpoint at step N sees the same tokens with no
iterator state to save.  The text is a small hidden Markov chain (a fresh
transition matrix every step over 16 latent states, each state owning one
band of the vocabulary), so a model can learn it.

``jax.random`` cannot be reproduced outside JAX: the port draws the same
structure from numpy's generator, seeded by ``(seed, step, host_index)``,
on the host.  The batch comes back as CPU int32 tensors; the caller moves
it to its device, so the card and the CPU train on the same tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_latent: int = 16            # HMM latent states
    frames: bool = False          # also emit audio-frame embeddings (encdec)
    d_model: int = 0              # frame dim when frames=True


def batch_for_step(cfg: DataConfig, step: int, host_index: int = 0,
                   host_count: int = 1) -> Dict[str, torch.Tensor]:
    """Pure (seed, step, host) -> this host's rows: ``tokens`` and
    ``labels`` (B/host_count, S) int32, labels the tokens rolled by one
    (the last label wraps to the first token); with ``cfg.frames`` also
    ``frames`` (B/host_count, S, d_model) f32, standard normal x 0.02,
    drawn from the same generator after the tokens."""
    if cfg.global_batch % host_count:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {host_count} hosts")
    per_host = cfg.global_batch // host_count
    rng = np.random.default_rng([cfg.seed, step, host_index])
    nl = cfg.n_latent
    # per-step latent Markov chain (shared across the host's rows)
    logits = rng.standard_normal((nl, nl)) * 2.0
    trans = np.exp(logits - logits.max(-1, keepdims=True))
    trans /= trans.sum(-1, keepdims=True)
    cdf = np.cumsum(trans, axis=-1)
    state = rng.integers(0, nl, per_host)
    u = rng.random((cfg.seq_len, per_host))
    states = np.empty((per_host, cfg.seq_len), np.int64)
    for t in range(cfg.seq_len):
        # categorical draw from row ``state`` of the chain
        state = np.minimum((u[t, :, None] > cdf[state]).sum(-1), nl - 1)
        states[:, t] = state
    # emit: each latent state owns a band of the vocabulary
    band = max(cfg.vocab_size // nl, 1)
    noise = rng.integers(0, band, states.shape)
    tokens = np.minimum(states * band + noise, cfg.vocab_size - 1)
    tokens = torch.from_numpy(tokens.astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.frames:
        frames = rng.standard_normal((per_host, cfg.seq_len, cfg.d_model),
                                     dtype=np.float32) * np.float32(0.02)
        batch["frames"] = torch.from_numpy(frames)
    return batch


def token_stream(cfg: DataConfig, start_step: int = 0, host_index: int = 0,
                 host_count: int = 1
                 ) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    """Infinite generator of (step, batch)."""
    step = start_step
    while True:
        yield step, batch_for_step(cfg, step, host_index, host_count)
        step += 1
