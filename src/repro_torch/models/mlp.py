"""Feed-forward blocks (port of ``repro/models/mlp.py``): the SwiGLU of
the llama family (``act="silu"``) and the classic non-gated GELU
(``act="gelu"``: ``w_in``, ``w_out``, no ``w_gate``).  ``jax.nn.gelu``
defaults to the tanh approximation, and so does this one."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import shard
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def mlp_init(gen, cfg: ModelConfig, *, device,
             dtype: torch.dtype = torch.float32) -> L.Params:
    d_ff = cfg.d_ff
    p = {
        "w_in": L.linear_init(gen, cfg.d_model, d_ff, device=device,
                              dtype=dtype),
        "w_out": L.linear_init(gen, d_ff, cfg.d_model, device=device,
                               std=d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                               dtype=dtype),
    }
    if cfg.act == "silu":                      # SwiGLU needs the gate
        p["w_gate"] = L.linear_init(gen, cfg.d_model, d_ff, device=device,
                                    dtype=dtype)
    return p


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    h = L.linear_apply(params["w_in"], x, dtype=dt)
    h = shard(h, "batch", None, "mlp")
    if cfg.act == "silu":
        g = L.linear_apply(params["w_gate"], x, dtype=dt)
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return L.linear_apply(params["w_out"], h, dtype=dt)
