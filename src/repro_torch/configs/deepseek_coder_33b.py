"""deepseek-coder-33b — dense llama-arch GQA [arXiv:2401.14196]: 56 query
heads over 8 KV heads, a GQA group of 7.  The same values as
``repro/configs/deepseek_coder_33b.py`` (its ``max_seq`` is not a field of
the port's config).  33.3 B parameters: 66.7 GB in bf16."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256,
    norm="rmsnorm", act="silu", rope_theta=1e5,
    tie_embeddings=False, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="deepseek-coder-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, tie_embeddings=False,
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": "pure full attention — skipped per assignment"},
    source="[arXiv:2401.14196; hf]",
)
