"""Trainer-coherent hot-row cache for the pool-backed serving tier
(counterpart of ``repro.serve.cache``).

A plain LRU over *row bytes*: key = flat row id, value = the float32 row as
last gathered from the embedding mirror. The cache is write-never: rows only
enter via ``put_many`` after a pool gather, and leave via LRU pressure or
``invalidate``. Coherence is the caller's job: the commit tailer
(``serve.coherence``) evicts exactly the rows each committed training step
touched, so a hit is always the post-commit row image.

The in-process commit hook evicts on the trainer's writer thread, while a
serving thread may be between its pool gather and its ``put_many``. Every
``invalidate`` advances ``epoch``; a fill passes the epoch it read before
its gather as ``since``, and ``put_many`` drops the rows invalidated after
it, so a row gathered before a commit's apply never enters the cache after
that commit's eviction. (The JAX package's cache has no epoch: there such a
row stays cached until LRU pressure evicts it.)

Counters go through ``PoolMetrics.record_cache``, beside the pool traffic
they offset.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Optional

import numpy as np

from repro_torch.pool.metrics import PoolMetrics

_INVAL_LOG = 64     # invalidations remembered for the fills they overlap


class HotRowCache:
    def __init__(self, capacity_rows: int = 4096,
                 metrics: Optional[PoolMetrics] = None):
        self.capacity = max(1, int(capacity_rows))
        self.metrics = metrics
        self._rows: OrderedDict[int, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()
        self.epoch = 0
        # (epoch, ids) of the newest invalidations; ids None for a clear
        self._recent: deque = deque(maxlen=_INVAL_LOG)

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, row_id) -> bool:
        return int(row_id) in self._rows

    def get_many(self, ids) -> tuple[dict, list]:
        """Split ``ids`` into ({id: row} hits, [missing ids]). Hits move to
        the MRU end; the rows returned are read-only views of the cached
        batch blocks, not copies: callers copy before mutating."""
        hits: dict[int, np.ndarray] = {}
        missing: list[int] = []
        with self._lock:
            for i in ids:
                i = int(i)
                row = self._rows.get(i)
                if row is None:
                    missing.append(i)
                else:
                    self._rows.move_to_end(i)
                    hits[i] = row
        if self.metrics is not None:
            self.metrics.record_cache(hits=len(hits), misses=len(missing))
        return hits, missing

    def put_many(self, ids, rows: np.ndarray, since: Optional[int] = None):
        """Insert gathered rows (rows[k] is the row for ids[k]); evicts LRU
        entries beyond capacity. The batch enters as read-only views of ONE
        shared block, the gather result itself (a fresh array per gather,
        so aliasing it is safe), not one copy per row. ``since`` is the
        ``epoch`` read before the gather: rows invalidated after it are
        left out."""
        block = np.asarray(rows).view()
        block.setflags(write=False)
        with self._lock:
            stale = self._invalidated_since(since)
            if stale is None:
                return
            for k, i in enumerate(ids):
                i = int(i)
                if i not in stale:
                    self._rows[i] = block[k]
                    self._rows.move_to_end(i)
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)

    def _invalidated_since(self, since: Optional[int]) -> Optional[set]:
        """The ids invalidated after epoch ``since``, or None for all of
        them (a clear, or invalidations older than the log remembers)."""
        if since is None or since == self.epoch:
            return set()
        if self._recent[0][0] > since + 1:
            return None
        stale: set[int] = set()
        for e, ids in self._recent:
            if e > since:
                if ids is None:
                    return None
                stale.update(ids.tolist())
        return stale

    def invalidate(self, ids) -> int:
        """Drop exactly ``ids`` (the rows a committed step touched). Returns
        how many were cached: the serving tier asserts on it to show that
        invalidation is exact, not a flush."""
        ids = np.array(ids, dtype=np.int64).reshape(-1)     # kept in the log
        n = 0
        with self._lock:
            self.epoch += 1
            self._recent.append((self.epoch, ids))
            for i in ids.tolist():
                if self._rows.pop(i, None) is not None:
                    n += 1
        if self.metrics is not None and n:
            self.metrics.record_cache(invalidations=n)
        return n

    def clear(self) -> int:
        with self._lock:
            n = len(self._rows)
            self._rows.clear()
            self.epoch += 1
            self._recent.append((self.epoch, None))
        if self.metrics is not None and n:
            self.metrics.record_cache(invalidations=n)
        return n

