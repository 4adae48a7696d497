"""Serve steps shared by the engines and the schedulers (port of
``repro/launch/steps.py``: the dense and paged prefill steps, the decode
and verify steps and the draft loop)."""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """(params, {"tokens": (B,S)}) -> (last_logits, cache): a fresh dense
    cache of ``cache_len`` positions, filled and calibrated by the batch."""

    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache = T.make_cache(cfg, tokens.shape[0], cache_len,
                             device=tokens.device)
        return T.prefill(params, tokens, cfg, cache)

    return prefill_step


def make_paged_prefill_step(cfg: ModelConfig, *, calibrate: bool):
    """(params, tokens (B,S), cache, slot_ids (B,), block_ids (B, mb))
    -> (last_logits, cache).  Writes only the named slots' blocks and table
    rows; ``calibrate`` fixes the pool's per-layer scales (first admission)."""

    def prefill_step(params, tokens, cache, slot_ids, block_ids):
        return T.prefill_paged(params, tokens, cfg, cache, slot_ids,
                               block_ids, calibrate=calibrate)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, token (B,), cache) -> (logits (B, V), cache), on a paged or
    a dense cache (``transformer.decode_step`` tells them apart)."""

    def decode_step(params, token, cache):
        return T.decode_step(params, token, cfg, cache)

    return decode_step


def make_verify_step(cfg: ModelConfig):
    """(params, tokens (B,T), cache) -> (logits (B,T,V), cache): the
    speculative target step, one verify launch per layer, whose
    ``logits[:, t]`` is what the decode step gives after accepting
    ``tokens[:, :t+1]``."""

    def verify_step(params, tokens, cache):
        return T.verify_step(params, tokens, cfg, cache)

    return verify_step


def make_draft_loop(cfg: ModelConfig, gamma: int):
    """(params, token (B,), cache) -> (drafts (B, gamma), cache).

    The drafter's ``gamma`` greedy decode steps, argmax on the device and no
    host read inside the loop (the reference scans them into one launch;
    here they are ``gamma`` eager steps).  ``drafts[:, 0]`` continues
    ``token``; the cache comes back ``gamma`` tokens longer and is
    truncated by the scheduler after verification.
    """

    def draft_loop(params, token, cache):
        drafts = []
        for _ in range(gamma):
            logits, cache = T.decode_step(params, token, cfg, cache)
            token = torch.argmax(logits, dim=-1)
            drafts.append(token)
        return torch.stack(drafts, dim=1), cache

    return draft_loop
