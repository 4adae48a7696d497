"""SwiGLU feed-forward block (port of ``repro/models/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def mlp_init(gen, cfg: ModelConfig, *, device,
             dtype: torch.dtype = torch.float32) -> L.Params:
    d_ff = cfg.d_ff
    return {
        "w_in": L.linear_init(gen, cfg.d_model, d_ff, device=device,
                              dtype=dtype),
        "w_out": L.linear_init(gen, d_ff, cfg.d_model, device=device,
                               std=d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                               dtype=dtype),
        "w_gate": L.linear_init(gen, cfg.d_model, d_ff, device=device,
                                dtype=dtype),
    }


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    h = L.linear_apply(params["w_in"], x, dtype=dt)
    g = L.linear_apply(params["w_gate"], x, dtype=dt)
    return L.linear_apply(params["w_out"], F.silu(g) * h, dtype=dt)
