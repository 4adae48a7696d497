"""Train and serve steps shared by the trainer, the engines and the
schedulers (port of ``repro/launch/steps.py``: the loss, the plain,
compressed and gradient-accumulation train steps, and the dense and paged
prefill steps, the decode and verify steps and the draft loop; each serve
step dispatches the encoder-decoder family to ``models.encdec``, which has
no speculative steps; the SSM and hybrid families go through
``models.transformer``, and have none either).

A train step computes the loss and its gradients with autograd and
updates the parameters and the optimizer state **in place** (the port's
counterpart of the reference's donated buffers); it returns them for
symmetry with the reference's functional API.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.dist import compression as comp
from repro_torch.dist import sharding as sh
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  logical_vocab: int) -> torch.Tensor:
    """Mean next-token CE over the *logical* vocab: logits (B, S, V_padded)
    in f32 with the padding lanes at -1e30, the log-sum-exp in f32, the mean
    over B x S."""
    vp = logits.shape[-1]
    logits = logits.to(torch.float32)
    if vp != logical_vocab:
        lane = torch.arange(vp, device=logits.device)
        logits = torch.where(lane >= logical_vocab, -1e30, logits)
    if sh.current_axis_rules() is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        lse = _LogSumExp.apply(logits)
        # sharding-aware: with the vocab dim sharded, a lane compare and a
        # sum leave partial sums of B x S values to reduce, where a gather
        # would need every row whole (the reference's formulation; the
        # same values, its one nonzero term summed with zeros)
        lane = torch.arange(vp, device=logits.device)
        gold = torch.sum(torch.where(lane == labels.long()[..., None],
                                     logits, 0.0), dim=-1)
    return torch.mean(lse - gold)


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim in its own ops, bit for bit
    (the row max, infinite maxes taken as 0, ``log(sum(exp(x - max))) +
    max``; the backward ``g * exp(x - lse)``), written out so that each op
    keeps a sharded vocab dim sharded: the max and the sum reduce B x S
    partial values, where DTensor's ``logsumexp`` gathers every row of
    logits whole."""

    @staticmethod
    def forward(ctx, x):
        m = torch.amax(x, dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), 0.0, m)
        lse = torch.log(torch.sum(torch.exp(x - m), dim=-1)) + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None])


def loss_fn(params, batch: Dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if cfg.family == "encdec":
        logits, aux = E.forward(params, batch, cfg)
    else:
        logits, aux = T.forward(params, batch["tokens"], cfg)
    ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    loss = ce + aux["aux_loss"] + aux["z_loss"]
    return loss, {"loss": loss, "ce": ce, "aux_loss": aux["aux_loss"],
                  "z_loss": aux["z_loss"]}


def value_and_grad(params, batch: Dict, cfg: ModelConfig):
    """``(loss, metrics), grads``: the gradient of ``loss_fn`` with respect
    to every leaf of ``params``, as a tree shaped like it (f32 for f32
    parameters).  On a mesh each gradient is laid out as its parameter:
    reduced once here (a partial sum over "data" reduce-scattered), where
    the optimizer would reduce a partial gradient whole at each of its
    uses, and a gradient that came out whole on "model" (``wo``'s: its
    input is gathered whole there) kept split as the weight is."""
    leaves = tu.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, batch, cfg)
    grads = [g.redistribute(g.device_mesh, p.placements)
             if hasattr(g, "placements") and g.placements != p.placements
             else g for p, g in zip(leaves, torch.autograd.grad(loss, leaves))]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tu.unflatten_like(params, list(grads))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptimizerConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def train_step(params, opt_state, batch):
        (_, metrics), grads = value_and_grad(params, batch, cfg)
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def _stack_names(cfg: ModelConfig):
    """The port's layer lists and, for each, how the reference stacks it:
    ``(name, [count of each stacked segment])`` -- an encoder-decoder's
    ``encoder`` and ``decoder`` one segment each; a decoder's ``layers``
    by ``layer_segments`` (a MoE config's leading dense layers, then its
    MoE layers; the hybrid's Mamba-2 layers one ``(groups, per)`` leaf,
    whose per-tensor scale is that of the layers stacked flat)."""
    if cfg.family == "encdec":
        return [("encoder", [cfg.n_encoder_layers]),
                ("decoder", [cfg.n_layers])]
    return [("layers", [n for _, n in T.layer_segments(cfg)])]


def _stacked(tree, cfg: ModelConfig):
    """The per-layer leaves of each layer list of ``tree`` stacked into
    one leaf a segment, as the reference's scanned segments hold them."""
    out = dict(tree)
    for name, counts in _stack_names(cfg):
        segs, i = [], 0
        for n in counts:
            segs.append(tu.tree_map(lambda *xs: torch.stack(xs),
                                    *tree[name][i:i + n]))
            i += n
        out[name] = segs
    return out


def _unstacked(tree, cfg: ModelConfig):
    out = dict(tree)
    for name, counts in _stack_names(cfg):
        out[name] = [tu.tree_map(lambda x: x[i], seg)
                     for seg, n in zip(tree[name], counts) for i in range(n)]
    return out


def make_compressed_train_step(cfg: ModelConfig,
                               opt_cfg: adamw.OptimizerConfig):
    """(params, opt_state, err, batch) -> (params, opt_state, err, metrics):
    the gradient passes the int8 error-feedback pipe
    (:mod:`repro_torch.dist.compression`) before the optimizer; ``err``
    comes from ``compression.init_error(params)``.  Each quantization
    scale covers a leaf of the reference's layout, so a layer weight's
    scale is shared by all layers of its segment, as in the reference's
    stacked segments."""

    def train_step(params, opt_state, err, batch):
        (_, metrics), grads = value_and_grad(params, batch, cfg)
        grads, err = comp.compressed_psum(_stacked(grads, cfg),
                                          _stacked(err, cfg), axis_name=None)
        grads, err = (_unstacked(t, cfg) for t in (grads, err))
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics.update(opt_metrics)
        return params, opt_state, err, metrics

    return train_step


def make_grad_accum_train_step(cfg: ModelConfig,
                               opt_cfg: adamw.OptimizerConfig):
    """Microbatched variant: the batch has a leading accumulation axis
    (A, B/A, S); gradients and losses are summed in f32 over the A
    microbatches in order and divided by ``opt_cfg.accum_steps``."""

    def train_step(params, opt_state, batch):
        gsum = tu.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=tu.leaves(params)[0].device)
        for i in range(batch["tokens"].shape[0]):
            mb = {k: v[i] for k, v in batch.items()}
            (loss, _), g = value_and_grad(params, mb, cfg)
            gsum = tu.tree_map(torch.add, gsum, g)
            lsum = lsum + loss
        n = opt_cfg.accum_steps
        grads = tu.tree_map(lambda g: g / n, gsum)
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg)
        opt_metrics["loss"] = lsum / n
        return params, opt_state, opt_metrics

    return train_step


def init_params_fn(cfg: ModelConfig):
    """``fn(seed=..., device=..., serving=...)`` -> random parameters of
    ``cfg``."""
    if cfg.family == "encdec":
        return functools.partial(E.init_params, cfg)
    return functools.partial(T.init_params, cfg)


def _no_speculation(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"speculative serving is decoder-only (the dense "
                         f"and MoE families): the {cfg.family} family has no "
                         f"verify step or draft loop, as in the reference")


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, cache_len: int, *, place=None):
    """(params, {"tokens": (B,S)} [+ "frames"]) -> (last_logits, cache): a
    fresh dense cache of ``cache_len`` positions, filled and calibrated by
    the batch.  ``place(cache) -> cache`` lays the fresh cache out before
    it is filled (the dry-run places it on the mesh, as the reference's
    ``out_shardings`` do)."""
    place = place or (lambda cache: cache)

    if cfg.family == "encdec":
        def prefill_step(params, batch):
            tokens, frames = batch["tokens"], batch["frames"]
            cache = place(E.make_cache(cfg, tokens.shape[0], cache_len,
                                       frames.shape[1], device=tokens.device))
            return E.prefill(params, frames, tokens, cfg, cache)
        return prefill_step

    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache = place(T.make_cache(cfg, tokens.shape[0], cache_len,
                                   device=tokens.device))
        return T.prefill(params, tokens, cfg, cache)

    return prefill_step


def make_paged_prefill_step(cfg: ModelConfig, *, calibrate: bool):
    """(params, tokens (B,S), cache, slot_ids (B,), block_ids (B, mb))
    -> (last_logits, cache).  Writes only the named slots' blocks and table
    rows; ``calibrate`` fixes the pool's per-layer scales (first admission).
    The encdec step takes the encoder frames too: (params, frames (B, S_enc,
    d), tokens, cache, slot_ids, block_ids)."""

    if cfg.family == "encdec":
        def prefill_step(params, frames, tokens, cache, slot_ids, block_ids):
            return E.prefill_paged(params, frames, tokens, cfg, cache,
                                   slot_ids, block_ids, calibrate=calibrate)
        return prefill_step

    def prefill_step(params, tokens, cache, slot_ids, block_ids):
        return T.prefill_paged(params, tokens, cfg, cache, slot_ids,
                               block_ids, calibrate=calibrate)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, token (B,), cache) -> (logits (B, V), cache), on a paged or
    a dense cache (``transformer.decode_step`` tells them apart; an encdec
    paged cache carries the carved bank's ``cross_table``)."""

    if cfg.family == "encdec":
        def decode_step(params, token, cache):
            if "cross_table" in cache:
                return E.decode_step_paged(params, token, cfg, cache)
            return E.decode_step(params, token, cfg, cache)
        return decode_step

    def decode_step(params, token, cache):
        return T.decode_step(params, token, cfg, cache)

    return decode_step


def make_verify_step(cfg: ModelConfig):
    """(params, tokens (B,T), cache) -> (logits (B,T,V), cache): the
    speculative target step, one verify launch per layer, whose
    ``logits[:, t]`` is what the decode step gives after accepting
    ``tokens[:, :t+1]``."""
    _no_speculation(cfg)

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
    _no_speculation(cfg)

    def draft_loop(params, token, cache):
        drafts = []
        for _ in range(gamma):
            logits, cache = T.decode_step(params, token, cfg, cache)
            token = torch.argmax(logits, dim=-1)
            drafts.append(token)
        return torch.stack(drafts, dim=1), cache

    return draft_loop
