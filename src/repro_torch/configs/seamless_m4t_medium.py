"""seamless-m4t-medium -- encoder-decoder, multimodal audio
[arXiv:2308.11596].  The same values as
``repro/configs/seamless_m4t_medium.py`` (its ``max_seq`` is not a field
of the port's config).

Backbone only: the speech frontend is a stub, and the encoder consumes
precomputed frame embeddings ``(B, frames, d_model)``
(``models/frontend.py``).  It runs all three of the paper's transformer
mappings (encoder-only, decoder-only, encoder-decoder): see
``models/encdec.py``."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_encoder_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    norm="layernorm", act="gelu", rope_theta=1e4,
    tie_embeddings=True, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, norm="layernorm", act="gelu",
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": "full-attention decoder — skipped per "
                              "assignment"},
    source="[arXiv:2308.11596; hf]",
)
