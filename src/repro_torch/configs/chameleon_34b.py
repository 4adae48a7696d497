"""chameleon-34b — early-fusion VLM backbone, VQ image tokens
[arXiv:2405.09818]: image content arrives as token ids inside the
65536-entry vocabulary (the VQ-VAE tokenizer is not ported).  Per-head
query-key RMSNorm (``qk_norm``); tied by the default.  The same values as
``repro/configs/chameleon_34b.py`` (its ``max_seq`` is not a field of the
port's config).  33.8 B parameters: 67.5 GB in bf16."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536,
    norm="rmsnorm", act="silu", qk_norm=True,
    rope_theta=1e4, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="chameleon-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, qk_norm=True,
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": "pure full attention (quadratic prefill, "
                              "unbounded KV) — skipped per assignment"},
    source="[arXiv:2405.09818; unverified]",
)
