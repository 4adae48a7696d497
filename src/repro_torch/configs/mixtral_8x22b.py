"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].  The same values as ``repro/configs/mixtral_8x22b.py``
(its ``norm``, ``act`` and ``max_seq`` are not fields of the port's
config).  141 B parameters: 282 GB in bf16, more than one card holds, so
the port runs it at the smoke size only (full width waits for sharding,
ROADMAP queue 1 item 11)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384,
                  capacity_factor=1.25),
    window=4096,
    rope_theta=1e6, tie_embeddings=False, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
    window=32, tie_embeddings=False,
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={},
    source="[arXiv:2401.04088; hf]",
)
