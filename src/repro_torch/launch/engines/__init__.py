"""Cache engines behind the scheduler (port of ``repro/launch/engines``:
the paged-KV engine of the dense and MoE families and the
encoder-decoder engine; the SSM engine is not ported)."""
from repro_torch.launch.engines.base import CacheEngine, PoolManager
from repro_torch.launch.engines.paged_kv import PagedKVEngine
from repro_torch.launch.engines.encdec import EncDecEngine

__all__ = ["CacheEngine", "EncDecEngine", "PagedKVEngine", "PoolManager"]
