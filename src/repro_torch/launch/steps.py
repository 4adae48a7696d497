"""Serve steps shared by the engines (port of ``repro/launch/steps.py``,
the paged prefill and decode steps)."""
from __future__ import annotations

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_paged_prefill_step(cfg: ModelConfig, *, calibrate: bool):
    """(params, tokens (B,S), cache, slot_ids (B,), block_ids (B, mb))
    -> (last_logits, cache).  Writes only the named slots' blocks and table
    rows; ``calibrate`` fixes the pool's per-layer scales (first admission)."""

    def prefill_step(params, tokens, cache, slot_ids, block_ids):
        return T.prefill_paged(params, tokens, cfg, cache, slot_ids,
                               block_ids, calibrate=calibrate)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, token (B,), cache) -> (logits (B, V), cache)."""

    def decode_step(params, token, cache):
        return T.decode_step(params, token, cfg, cache)

    return decode_step
