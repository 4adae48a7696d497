"""Cache engines behind the scheduler (port of ``repro/launch/engines``;
the dense paged-KV engine so far)."""
from repro_torch.launch.engines.base import CacheEngine, PoolManager
from repro_torch.launch.engines.paged_kv import PagedKVEngine

__all__ = ["CacheEngine", "PagedKVEngine", "PoolManager"]
