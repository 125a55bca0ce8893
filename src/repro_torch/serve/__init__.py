"""repro_torch.serve — the pool-backed embedding serving tier (counterpart
of ``repro.serve``, local pools).

Reads the trainer's pool-resident embedding mirror directly (no export or
reload pipeline):

  cache.py      trainer-coherent hot-row LRU (counters in ``PoolMetrics``)
  batcher.py    request coalescing: dedup + one ``gather`` per batch
  coherence.py  commit-driven invalidation (undo-log tailer / commit hook)
  frontend.py   ``EmbeddingServeTier``, the composed serving surface,
                API-compatible with ``EmbeddingPoolMirror`` so
                ``core.embedding_ops.attach_pool`` accepts it

The JAX package's ``replica.py`` reads a sharded pool's replica domain and
is not ported (the sharded pool is not).
"""
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.cache import HotRowCache
from repro_torch.serve.coherence import CommitTailer, make_commit_hook
from repro_torch.serve.frontend import EmbeddingServeTier

__all__ = [
    "CommitTailer", "EmbeddingServeTier", "HotRowCache", "RequestBatcher",
    "make_commit_hook",
]
