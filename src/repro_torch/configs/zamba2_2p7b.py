"""zamba2-2.7b -- a Mamba-2 backbone and one shared attention block
[arXiv:2411.15242].  The same values as ``repro/configs/zamba2_2p7b.py``
(its ``max_seq`` is not a field of the port's config).

54 Mamba-2 blocks; one *shared* attention + MLP block (one parameter set)
runs before every 6 of them on concat(hidden, embeddings), 9 times a
token.  The split softmax applies to the shared attention (32/32 heads of
80); the model serves through the dense cache (``--cache dense``): the
reference has no paged engine for the hybrid family."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                  headdim=64, chunk=256),
    hybrid_attn_every=6,
    norm="rmsnorm", act="silu", rope_theta=1e4, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    ssm=SSMConfig(kind="mamba2", d_state=8, headdim=16, chunk=8),
    hybrid_attn_every=2,
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={},
    source="[arXiv:2411.15242; hf]",
)
