"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066].  First layer stays dense (as in the release).  The
same values as ``repro/configs/deepseek_moe_16b.py`` (its ``norm``,
``act`` and ``max_seq`` are not fields of the port's config)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944,                       # the single dense layer's FFN
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  capacity_factor=1.25, first_dense_layers=1),
    rope_theta=1e4, tie_embeddings=False, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=3, d_ff_expert=32, n_shared=2,
                  first_dense_layers=1),
    tie_embeddings=False,
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": "pure full attention — skipped per assignment"},
    source="[arXiv:2401.06066; hf]",
)
