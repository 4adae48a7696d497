"""tinyllama-1.1b — the paper's own accuracy-evaluation model
[arXiv:2401.02385]; the same values as ``repro/configs/tinyllama_1p1b.py``
(RMSNorm, SwiGLU and the untied LM head are the port's only block)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32000, rope_theta=1e4, tie_embeddings=False,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="tinyllama-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, tie_embeddings=False,
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": "pure full attention — not in assigned grid"},
    source="[arXiv:2401.02385; hf]",
)
