"""repro_torch.serve — the pool-backed embedding serving tier (counterpart
of ``repro.serve``).

Reads the trainer's pool-resident embedding mirror directly (no export or
reload pipeline):

  cache.py      trainer-coherent hot-row LRU (counters in ``PoolMetrics``)
  batcher.py    request coalescing: dedup + one ``gather`` per batch
  coherence.py  commit-driven invalidation (undo-log tailer / commit hook)
  replica.py    ``ReplicaReader``: reads a sharded pool's read-replica
                domain and its watermark
  frontend.py   ``EmbeddingServeTier``, the composed serving surface,
                API-compatible with ``EmbeddingPoolMirror`` so
                ``core.embedding_ops.attach_pool`` accepts it; fails reads
                over to a replica
"""
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.cache import HotRowCache
from repro_torch.serve.coherence import CommitTailer, make_commit_hook
from repro_torch.serve.frontend import EmbeddingServeTier
from repro_torch.serve.replica import ReplicaReader

__all__ = [
    "CommitTailer", "EmbeddingServeTier", "HotRowCache", "ReplicaReader",
    "RequestBatcher", "make_commit_hook",
]
