"""olmo-1b — dense, *non-parametric* LayerNorm [arXiv:2402.00838]; tied
embeddings.  The same values as ``repro/configs/olmo_1b.py`` (its
``max_seq`` is not a field of the port's config; the smoke twin is tied by
the default, as the reference's is)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304,
    norm="nonparam_ln", act="silu", rope_theta=1e4,
    tie_embeddings=True, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="olmo-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512, norm="nonparam_ln",
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": "pure full attention — skipped per assignment"},
    source="[arXiv:2402.00838; hf]",
)
