"""Architecture configuration (port of ``repro/models/config.py``, the
fields the dense decoder's training and int8 serving paths read).

The port's dense family is the llama block: RMSNorm, SwiGLU, an untied
f32 LM head; the reference's ``norm``, ``act``, ``tie_embeddings`` and
``logits_dtype`` have one value in use and are not fields here."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.attention import AttentionSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 1e4
    dtype: str = "float32"    # compute dtype ("bfloat16" for production)
    vocab_pad_multiple: int = 256
    # attention datapath: train in attn_mode, serve in serve_attn_mode
    attn_mode: str = "fakequant"      # float | fakequant | int8 (training)
    serve_attn_mode: str = "int8"     # mode of the serve steps
    scale_z: float = 8.0 / 127        # score quantization scale of the LUTs
    window: Optional[int] = None      # sliding-window attention
    attn_fused: bool = True           # fused decode kernel; False = composed
    # training perf levers (defaults = the paper-faithful baseline)
    attn_score_dtype: str = "float32"
    attn_triangular: bool = False
    remat: bool = True                # checkpoint each block in training

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def attn_spec(self, *, serve: bool = False) -> AttentionSpec:
        """The training spec (``attn_mode``), or with ``serve=True`` the
        serving one (``serve_attn_mode``)."""
        return AttentionSpec(
            mode=self.serve_attn_mode if serve else self.attn_mode,
            scale_z=self.scale_z, window=self.window,
            fused=self.attn_fused, score_dtype=self.attn_score_dtype,
            triangular=self.attn_triangular)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
