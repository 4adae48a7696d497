"""Cache engines behind the scheduler (port of ``repro/launch/engines``:
the paged-KV engine of the dense and MoE families, the SSM family's
int8 state-slab engine and the encoder-decoder engine)."""
from repro_torch.launch.engines.base import CacheEngine, PoolManager
from repro_torch.launch.engines.paged_kv import PagedKVEngine
from repro_torch.launch.engines.ssm import SSMStateEngine
from repro_torch.launch.engines.encdec import EncDecEngine

__all__ = ["CacheEngine", "EncDecEngine", "PagedKVEngine", "PoolManager",
           "SSMStateEngine"]
