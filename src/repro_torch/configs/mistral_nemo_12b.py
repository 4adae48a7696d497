"""mistral-nemo-12b — dense GQA, 128k context
[hf:mistralai/Mistral-Nemo-Base-2407].  Its 32 heads of 128 make 4096
query columns, narrower than d_model 5120.  The same values as
``repro/configs/mistral_nemo_12b.py`` (its ``max_seq`` is not a field of
the port's config).  12.25 B parameters, 24.5 GB in bf16: one card holds
it at full width."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    norm="rmsnorm", act="silu", rope_theta=1e6,
    tie_embeddings=False, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="mistral-nemo-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, tie_embeddings=False,
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": "pure full attention — skipped per assignment"},
    source="[hf:mistralai/Mistral-Nemo-Base-2407; hf]",
)
