"""falcon-mamba-7b -- pure Mamba-1 SSM, attention-free [arXiv:2410.05355].
The same values as ``repro/configs/falcon_mamba_7b.py`` (its ``max_seq``
is not a field of the port's config).

No softmax anywhere, so the paper's split softmax does not apply; the
model serves through the int8 state-slab engine
(``launch/engines/ssm.py``) or the dense cache's float state, its
projections in the compute dtype and its selective scan chunked
(``models/ssm.py``)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=65024,
    ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2, chunk=256),
    norm="rmsnorm", tie_embeddings=False, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=512,
    ssm=SSMConfig(kind="mamba1", d_state=8, chunk=8),
    tie_embeddings=False,
)

ARCH = ArchSpec(
    config=CONFIG, smoke=SMOKE,
    skip_shapes={},
    source="[arXiv:2410.05355; unverified]",
)
