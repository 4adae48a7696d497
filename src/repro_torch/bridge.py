"""Weight and optimizer-state bridge between the JAX reference's layout
and the port's.

The reference draws its parameters with ``jax.random``, which torch cannot
regenerate, so parity tests take the JAX parameters after
``jax.device_get`` — a pytree of numpy arrays — and convert them here.
This module takes numpy only and never imports JAX.

Layouts carry over unchanged (a linear weight is ``(d_in, d_out)`` in both
packages); the one structural change is that the reference scans stacked
layer segments, ``params["segments"]``, each homogeneous (a MoE config's
leading dense layers, then its MoE layers) with a leading layer axis on
every leaf, which become the port's one list ``params["layers"]``; an
encoder-decoder's stacked ``encoder`` and ``decoder`` become one list
each.
:func:`to_jax_layout` is the inverse map, which the trainer's checkpoints
use so that the reference restores them.  A non-parametric norm is the
empty dict in both layouts, and a tied config has no ``lm_head`` in
either.
"""
from __future__ import annotations

from typing import Any, Dict

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
    return "moe" if "moe" in layer else "dense"


def _unstack(stacked: Dict, n: int, what: str, dev) -> list:
    m = np.shape(next(iter(tu.leaves(stacked))))[0]
    if m != n:
        raise ValueError(f"{m} stacked {what} layers where the config has "
                         f"{n}")
    return [_to_torch(_layer(stacked, i), dev) for i in range(n)]


def from_jax_params(np_params: Dict, cfg: ModelConfig, *, device="cuda"
                    ) -> Dict:
    """JAX parameters (numpy leaves) -> the port's layout: a dense or MoE
    model's segments' layers, in order, into ``layers``; an encoder-decoder's
    stacked ``encoder`` and ``decoder`` into one list each."""
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
    segments = layer_segments(cfg)
    segs = np_params["segments"]
    if len(segs) != len(segments):
        raise ValueError(f"{len(segs)} layer segments for {cfg.name}'s "
                         f"{segments}")
    if ("lm_head" in np_params) == cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings}, "
                         f"but the parameters "
                         f"{'have' if cfg.tie_embeddings else 'lack'} an "
                         f"lm_head")
    out = {k: _to_torch(v, dev) for k, v in np_params.items()
           if k != "segments"}
    out["layers"] = []
    for seg, (kind, n) in zip(segs, segments):
        m = np.shape(seg["attn"]["wq"]["w"])[0]     # every layer has it
        if m != n or _kind(seg) != kind:
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


def to_jax_layout(params: Dict) -> Dict:
    """The port's parameter tree -> the reference's, as numpy copies: each
    run of consecutive layers of one kind in the list ``layers`` becomes
    one stacked segment of ``segments``, and the lists ``encoder`` and
    ``decoder`` one stacked tree each, each leaf with a leading layer
    axis."""
    def stack(run):
        return tu.tree_map(
            lambda *xs: np.stack([tu.host_copy(x) for x in xs]), *run)

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
