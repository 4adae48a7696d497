"""deepseek-67b — dense llama-arch GQA [arXiv:2401.02954].  The same
values as ``repro/configs/deepseek_67b.py`` (its ``max_seq`` is not a
field of the port's config).  67.4 B parameters: 134.9 GB in bf16, more
than one card holds; 67.4 GB as int8 serve weights
(``replace(serve_param_dtype="int8")``), which one 80 GB card serves at
full width."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400,
    norm="rmsnorm", act="silu", rope_theta=1e4,
    tie_embeddings=False, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, tie_embeddings=False,
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": "pure full attention — skipped per assignment"},
    source="[arXiv:2401.02954; hf]",
)
