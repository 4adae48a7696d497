"""AdamW with a cosine schedule and global-norm clipping (port of
``repro/optim/adamw.py``).

The optimizer state mirrors the parameter tree (``mu`` and ``nu`` have the
params' structure) and is updated **in place** under ``torch.no_grad()``,
all in f32; the step's scalars (the learning rate, ``1 - b1**step``,
``1 - b2**step``) are f32 values computed on the host as the reference
computes them, so a step does not depend on the device that runs it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as tu


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # gradient accumulation: effective batch = micro * accum
    accum_steps: int = 1


class OptState(NamedTuple):
    step: torch.Tensor       # int32, 0-d, on the CPU
    mu: Any                  # first moments  (params-shaped tree, f32)
    nu: Any                  # second moments


def init_state(params) -> OptState:
    return OptState(
        step=torch.zeros((), dtype=torch.int32),
        mu=tu.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
        nu=tu.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio * peak``: an f32
    0-d CPU tensor, in the reference's order of f32 operations."""
    step = _f32(step)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tu.leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` **in place** to a global norm of at most
    ``max_norm``; returns them and their norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    for g in tu.leaves(grads):
        g.mul_(scale)
    return grads, norm


def _is_decayed(path: str) -> bool:
    """Weight decay applies to matrices, not to norms, biases or scalars:
    on the dense decoder every ``w`` and the embedding table, not the norm
    scales (the reference's decision, which its tests pin leaf by leaf)."""
    lowered = path.lower()
    return not any(t in lowered for t in
                   ("norm", "bias", "scale", "a_log", "dt_bias"))


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptimizerConfig
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and the state's moments
    (``grads`` are clipped in place too).  Returns the same trees, the
    state with its step advanced, and ``lr`` and ``grad_norm``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - b1 ** _f32(step))
    bc2 = float(1 - b2 ** _f32(step))
    lr_f = float(lr)
    for (path, p), g, mu, nu in zip(tu.leaves_with_path(params),
                                    tu.leaves(grads), tu.leaves(state.mu),
                                    tu.leaves(state.nu)):
        g = g.to(torch.float32)
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(torch.square(g) * (1 - b2))
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if cfg.weight_decay and _is_decayed(tu.pathstr(path)):
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr_f * upd)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), {
        "lr": lr, "grad_norm": gnorm}
