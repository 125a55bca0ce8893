"""Pool-backed embedding serving tier (counterpart of
``repro.serve.frontend``): the disaggregated pool doing double duty. The trainer checkpoints INTO it, the serving fleet reads OUT of it,
with no export or reload in between.

``EmbeddingServeTier`` reads the trainer's ``embedding-mirror/rows`` region
directly:

  * batched reads: per-request id lists are coalesced, deduplicated and
    fetched with one ``gather`` near-memory op (``serve.batcher``);
  * hot-row cache: an LRU over row bytes kept trainer-coherent by evicting
    exactly the rows each committed step touched (``serve.coherence``: the
    in-process commit hook, or the undo-log tailer across processes);
  * replica failover: with a ``ReplicaReader`` attached (a sharded pool), a
    read that fails on the primary with a ``PoolError`` is served from the
    pinned replica shard instead, whose watermark bounds how stale the
    rows may be (``staleness_bound``).

The tier is API-compatible with ``EmbeddingPoolMirror`` (``lookup`` /
``bag_lookup`` / ``shape`` / ``metrics``), so ``embedding_ops.attach_pool``
accepts it and the models read the pool through the cache.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.checkpoint import undo_log
from repro_torch.pool.allocator import PoolAllocator, Region
from repro_torch.pool.device import PoolDevice, PoolError
from repro_torch.pool.metrics import PoolMetrics
from repro_torch.pool.nmp import NmpQueue
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.cache import HotRowCache
from repro_torch.serve.coherence import CommitTailer
from repro_torch.serve.replica import ReplicaReader

_LAT_WINDOW = 10000        # latency samples kept for the percentile stats


class EmbeddingServeTier:
    DOMAIN, REGION = "embedding-mirror", "rows"    # the trainer's mirror

    def __init__(self, pool: PoolDevice, *, cache_rows: int = 4096,
                 replica: "bool | ReplicaReader" = False):
        """``replica``: a ``ReplicaReader``, or True for one over ``pool``'s
        replica of the mirror, to fail reads over to."""
        self.pool = pool
        self.metrics = PoolMetrics(device_name="serve")
        self.alloc = PoolAllocator(pool)
        self.nmp = NmpQueue(pool)
        self.region: Optional[Region] = \
            self.alloc.domain(self.DOMAIN).get(self.REGION)
        self.cache = HotRowCache(cache_rows, metrics=self.metrics)
        self.batcher = RequestBatcher(self._gather, self.cache)
        self.tailer: Optional[CommitTailer] = None
        self._attach_tailer()
        self.replica: Optional[ReplicaReader] = None
        if isinstance(replica, ReplicaReader):
            self.replica = replica
        elif replica:
            self.replica = ReplicaReader(pool, domain=self.DOMAIN,
                                         name=self.REGION)
        self.failovers = 0
        self.requests = 0
        self.rows_served = 0
        self._serve_time_s = 0.0
        self._lat_s: list[float] = []

    # -- plumbing ------------------------------------------------------------
    def _attach_tailer(self) -> bool:
        """The undo ring may not exist yet (serving came up before the
        trainer's first commit): attach lazily, at the first batch that
        finds the ring's meta in the pool's directory. While the directory
        is unchanged that look-up parses nothing."""
        try:
            if self.alloc.domain(undo_log.DOMAIN).get("meta") is None:
                return False
            self.tailer = CommitTailer.attach(self.pool, self.cache)
            return True
        except PoolError:
            return False

    def _resolve(self) -> Region:
        if self.region is None:
            self.region = self.alloc.domain(self.DOMAIN).get(self.REGION)
        if self.region is None:
            raise PoolError(f"serve: no {self.DOMAIN}/{self.REGION} "
                            f"region in the pool (trainer not initialised?)")
        return self.region

    def _gather(self, idx: np.ndarray) -> np.ndarray:
        """The primary's gather, failing over to the replica: a dead or
        cut-off primary shard fails the op, and the replica's region routes
        (by offset) to its own node."""
        try:
            return self.nmp.gather(self._resolve(), idx)
        except PoolError:
            if self.replica is None:
                raise
            self.failovers += 1
            return self.replica.gather(idx)

    def poll_coherence(self) -> dict:
        """Tail the trainer's committed steps and evict exactly their rows.
        Called before every served batch; callable directly for tests and
        tighter staleness control."""
        if self.tailer is None and not self._attach_tailer():
            return {"steps": 0, "evicted": 0, "watermark": -1}
        try:
            return self.tailer.poll()
        except PoolError:
            # the undo ring lives with the primary mirror: with the primary
            # down there are no new commits to tail either, so the cache
            # stays coherent at the last polled watermark
            return {"steps": 0, "evicted": 0,
                    "watermark": self.tailer.watermark}

    # -- serving -------------------------------------------------------------
    def serve_batch(self, requests: Sequence) -> list[np.ndarray]:
        """One serving iteration: coherence poll, then batched cached
        lookup. Returns the per-request row blocks."""
        t0 = time.perf_counter()
        self.poll_coherence()
        out = self.batcher.lookup_batch(requests)
        dt = time.perf_counter() - t0
        self._serve_time_s += dt
        self.requests += len(requests)
        self.rows_served += sum(int(np.asarray(r).size) for r in requests)
        self._lat_s.append(dt)
        if len(self._lat_s) > _LAT_WINDOW:
            del self._lat_s[:len(self._lat_s) - _LAT_WINDOW]
        return out

    # -- EmbeddingPoolMirror API (embedding_ops.attach_pool) -----------------
    @property
    def shape(self):
        return self._resolve().shape

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        return self.serve_batch([ids])[0]

    def bag_lookup(self, ids: np.ndarray, combine: str = "sum") -> np.ndarray:
        """Bag lookups reduce pool-side. The reduced vectors are request-
        specific, not row-cacheable, so they bypass the cache but keep the
        coherence poll and the replica failover. On a stacked (T, R, d)
        region ``bag_gather`` adds the tables' row offsets (the JAX
        package's tier adds none)."""
        self.poll_coherence()
        ids = np.asarray(ids)
        try:
            return self.nmp.bag_gather(self._resolve(), ids, combine=combine)
        except PoolError:
            if self.replica is None:
                raise
            self.failovers += 1
            return self.replica.bag_gather(ids, combine=combine)

    def staleness_bound(self) -> int:
        """Commits the replica may trail the primary by now: the latest
        tailed commit minus the replica's watermark (0 with no replica)."""
        if self.replica is None or self.tailer is None:
            return 0
        wm = self.replica.watermark()
        if wm < 0 or self.tailer.watermark < 0:
            return 0
        return max(0, self.tailer.watermark - wm)

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        lat = np.sort(np.asarray(self._lat_s)) if self._lat_s else None
        return {
            "requests": self.requests,
            "rows": self.rows_served,
            "qps": (self.requests / self._serve_time_s
                    if self._serve_time_s > 0 else 0.0),
            "p50_ms": float(np.percentile(lat, 50) * 1e3)
            if lat is not None else 0.0,
            "p99_ms": float(np.percentile(lat, 99) * 1e3)
            if lat is not None else 0.0,
            "hit_rate": self.metrics.cache_hit_rate(),
            "cache_hits": self.metrics.cache_hits,
            "cache_misses": self.metrics.cache_misses,
            "invalidations": self.metrics.cache_invalidations,
            "watermark": self.tailer.watermark
            if self.tailer is not None else -1,
            "failovers": self.failovers,
            "wire": self.wire_stats(),
        }

    def wire_stats(self) -> dict:
        """The pool connection's transport counters (remote and sharded
        pools): negotiated wire revision, keepalives, per-request timeouts,
        stalls; {} on an in-process pool."""
        ws = getattr(self.pool, "wire_stats", None)
        return ws() if callable(ws) else {}
