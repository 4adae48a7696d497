"""Architecture configuration (port of ``repro/models/config.py``, the
fields the dense int8 serving path reads).

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
    scale_z: float = 8.0 / 127        # score quantization scale of the LUTs
    window: Optional[int] = None      # sliding-window attention
    attn_fused: bool = True           # fused decode kernel; False = composed

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def attn_spec(self) -> AttentionSpec:
        """The int8 serving datapath (the port serves int8 only)."""
        return AttentionSpec(scale_z=self.scale_z, window=self.window,
                             fused=self.attn_fused)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
