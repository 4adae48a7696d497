"""Architecture configuration (port of ``repro/models/config.py``, the
fields the dense, MoE, SSM, hybrid and encoder-decoder models' training and
int8 serving paths read).

The block is the llama block with the reference's options: ``norm``
(RMSNorm, the parametric LayerNorm or OLMo's non-parametric one), ``act``
(the SwiGLU or the non-gated GELU MLP), the per-head q/k RMSNorm
(``qk_norm``) and the LM head tied to the embedding table
(``tie_embeddings``, the reference's default) or untied, in f32.  The
encoder-decoder family adds ``n_encoder_layers``; the SSM family (Mamba-1
or Mamba-2 layers) and the hybrid (Mamba-2 layers with one shared
attention block before every ``hybrid_attn_every`` of them) add ``ssm``.
``logits_dtype`` sets the LM head's dtype (None: f32, the reference's
default) and ``serve_param_dtype`` the serve weights: ``"int8"`` makes a
serving init (and ``cast_for_serving``) store every linear weight and
embedding table as int8 with an f32 scale, dequantized at use; any other
value keeps the serving init's compute-dtype weights."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.attention import AttentionSpec

NORMS = ("rmsnorm", "layernorm", "nonparam_ln")
ACTS = ("silu", "gelu")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0         # always-on shared experts (deepseek-moe)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0   # leading layers that stay dense
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str                 # "mamba1" | "mamba2"
    d_state: int
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64         # mamba2 only
    chunk: int = 128          # scan chunk length
    dt_rank: Optional[int] = None   # mamba1; default d_model/16


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"     # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"         # silu (SwiGLU) | gelu (non-gated, tanh approx.)
    qk_norm: bool = False     # chameleon-style per-head q/k RMSNorm
    rope_theta: float = 1e4
    tie_embeddings: bool = True
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
    logits_dtype: Optional[str] = None  # None -> float32 LM head
    serve_param_dtype: str = "float32"  # "int8": int8-resident serve weights
    serve_param_sharding: str = "fsdp"  # fsdp | tp: serve-time placement (tp
                                        # drops the fsdp factor: no per-step
                                        # parameter all-gather)
    seq_sharding: bool = False          # under a mesh binding, the residual
                                        # stream is seq-sharded over "model"
                                        # between matmuls
    remat: bool = True                # checkpoint each block in training
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 6        # zamba2: shared attn cadence
    n_encoder_layers: int = 0         # encdec only (0: n_layers)

    def __post_init__(self):
        if self.norm not in NORMS or self.act not in ACTS:
            raise ValueError(f"{self.name}: norm {self.norm!r}, act "
                             f"{self.act!r}: not in {NORMS}, {ACTS}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dtype(self) -> torch.dtype:
        """The LM head's dtype: ``logits_dtype``, f32 when None."""
        return getattr(torch, self.logits_dtype or "float32")

    @property
    def int8_weights(self) -> bool:
        """Whether the serve weights are int8-resident."""
        return self.serve_param_dtype == "int8"

    @property
    def d_inner(self) -> int:
        if self.ssm is None:
            raise ValueError(f"{self.name} has no SSM layers")
        return self.ssm.expand * self.d_model

    def attn_spec(self, *, serve: bool = False) -> AttentionSpec:
        """The training spec (``attn_mode``), or with ``serve=True`` the
        serving one (``serve_attn_mode``)."""
        return AttentionSpec(
            mode=self.serve_attn_mode if serve else self.attn_mode,
            scale_z=self.scale_z, window=self.window, causal=True,
            fused=self.attn_fused, score_dtype=self.attn_score_dtype,
            triangular=self.attn_triangular)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------ parameter counting ---------------------------------------------
    def param_count(self) -> int:
        """Exact trainable parameter count (excl. vocab padding)."""
        from repro_torch.models import transformer as tr
        return tr.count_params(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        from repro_torch.models import transformer as tr
        return tr.count_params(self, active_only=True)
