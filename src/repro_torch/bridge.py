"""Weight and optimizer-state bridge between the JAX reference's layout
and the port's.

The reference draws its parameters with ``jax.random``, which torch cannot
regenerate, so parity tests take the JAX parameters after
``jax.device_get`` — a pytree of numpy arrays — and convert them here.
This module takes numpy only and never imports JAX.

Layouts carry over unchanged (a linear weight is ``(d_in, d_out)`` in both
packages); the one structural change is that the reference scans stacked
layer segments, ``params["segments"]``, each homogeneous (a MoE config's
leading dense layers, then its MoE layers; an SSM config's Mamba layers
``{"norm1", "ssm"}``) with a leading layer axis on every leaf, which
become the port's one list ``params["layers"]``; the hybrid's Mamba-2
layers, stacked ``(groups, per, ...)`` in ``params["mamba_groups"]``,
become the same flat list (its ``shared_attn`` block carries over as it
is); an encoder-decoder's stacked ``encoder`` and ``decoder`` become one
list each.
:func:`to_jax_layout` is the inverse map, which the trainer's checkpoints
use so that the reference restores them.  A non-parametric norm is the
empty dict in both layouts, and a tied config has no ``lm_head`` in
either.  Int8 serve weights (``w_q``/``w_s``, ``table_q``/``table_s``)
cross like any leaf: a stacked ``(L, 1, 1)`` scale becomes each layer's
``(1, 1)`` and back.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tu
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import layer_segments
from repro_torch.optim.adamw import OptState


def _to_torch(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _kind(layer: Dict) -> str:
    """A layer's (or a stacked segment's) kind: dense, moe or ssm."""
    return next((k for k in ("moe", "ssm") if k in layer), "dense")


def _family_kind(kind: str) -> str:
    """A ``layer_segments`` kind as :func:`_kind` names it."""
    return "ssm" if kind.startswith("mamba") else kind


def _unstack(stacked: Dict, n: int, what: str, dev) -> list:
    m = np.shape(next(iter(tu.leaves(stacked))))[0]
    if m != n:
        raise ValueError(f"{m} stacked {what} layers where the config has "
                         f"{n}")
    return [_to_torch(_layer(stacked, i), dev) for i in range(n)]


def from_jax_params(np_params: Dict, cfg: ModelConfig, *, device="cuda"
                    ) -> Dict:
    """JAX parameters (numpy leaves) -> the port's layout: a dense, MoE or
    SSM model's segments' layers, in order, into ``layers``; the hybrid's
    ``(groups, per, ...)`` Mamba-2 stack, group by group, into ``layers``;
    an encoder-decoder's stacked ``encoder`` and ``decoder`` into one list
    each."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        out = {k: _to_torch(v, dev) for k, v in np_params.items()
               if k not in ("encoder", "decoder")}
        out["encoder"] = _unstack(np_params["encoder"],
                                  cfg.n_encoder_layers or cfg.n_layers,
                                  "encoder", dev)
        out["decoder"] = _unstack(np_params["decoder"], cfg.n_layers,
                                  "decoder", dev)
        return out
    if ("lm_head" in np_params) == cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings}, "
                         f"but the parameters "
                         f"{'have' if cfg.tie_embeddings else 'lack'} an "
                         f"lm_head")
    if cfg.family == "hybrid":
        out = {k: _to_torch(v, dev) for k, v in np_params.items()
               if k != "mamba_groups"}
        flat = tu.tree_map(lambda a: np.reshape(a, (-1,) + np.shape(a)[2:]),
                           np_params["mamba_groups"])
        out["layers"] = _unstack(flat, cfg.n_layers, "mamba", dev)
        return out
    segments = layer_segments(cfg)
    segs = np_params["segments"]
    if len(segs) != len(segments):
        raise ValueError(f"{len(segs)} layer segments for {cfg.name}'s "
                         f"{segments}")
    out = {k: _to_torch(v, dev) for k, v in np_params.items()
           if k != "segments"}
    out["layers"] = []
    for seg, (kind, n) in zip(segs, segments):
        m = np.shape(next(iter(tu.leaves(seg))))[0]
        if m != n or _kind(seg) != _family_kind(kind):
            raise ValueError(f"a segment of {m} {_kind(seg)} layers where "
                             f"{cfg.name} has {n} {kind} layers")
        out["layers"] += [_to_torch(_layer(seg, i), dev) for i in range(n)]
    return out


def from_jax_opt_state(np_state, cfg: ModelConfig, *, device="cuda"
                       ) -> OptState:
    """The reference's ``OptState(step, mu, nu)`` (numpy leaves) -> the
    port's; the step stays on the CPU."""
    step, mu, nu = np_state
    return OptState(
        step=torch.from_numpy(np.array(step, dtype=np.int32)),
        mu=from_jax_params(mu, cfg, device=device),
        nu=from_jax_params(nu, cfg, device=device))


def to_jax_layout(params: Dict, cfg: Optional[ModelConfig] = None) -> Dict:
    """The port's parameter tree -> the reference's, as numpy copies: each
    run of consecutive layers of one kind in the list ``layers`` becomes
    one stacked segment of ``segments``, and the lists ``encoder`` and
    ``decoder`` one stacked tree each, each leaf with a leading layer
    axis.  A hybrid's ``layers`` become ``mamba_groups``, each leaf
    ``(groups, per, ...)``, which needs its ``cfg`` for ``per``."""
    def stack(run):
        return tu.tree_map(
            lambda *xs: np.stack([tu.host_copy(x) for x in xs]), *run)

    if "shared_attn" in params:
        if cfg is None:
            raise ValueError("a hybrid's layout needs its config "
                             "(hybrid_attn_every)")
        per = cfg.hybrid_attn_every
        out = {k: tu.tree_map(tu.host_copy, v) for k, v in params.items()
               if k != "layers"}
        out["mamba_groups"] = tu.tree_map(
            lambda a: a.reshape((-1, per) + a.shape[1:]),
            stack(params["layers"]))
        return out
    if "encoder" in params:
        return {k: stack(v) if k in ("encoder", "decoder") else
                tu.tree_map(tu.host_copy, v) for k, v in params.items()}
    runs = []
    for layer in params["layers"]:
        if runs and _kind(runs[-1][-1]) == _kind(layer):
            runs[-1].append(layer)
        else:
            runs.append([layer])
    out = {k: tu.tree_map(tu.host_copy, v) for k, v in params.items()
           if k != "layers"}
    out["segments"] = [stack(run) for run in runs]
    return out
