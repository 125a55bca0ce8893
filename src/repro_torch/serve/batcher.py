"""Request batching and id coalescing for pool reads (counterpart of
``repro.serve.batcher``).

Serving requests arrive as small per-request id lists; one pool ``gather``
per request would pay one link round trip each. The batcher concatenates a
batch of requests, deduplicates the ids (``np.unique``), takes what it can
from the hot-row cache, and fetches the rest with ONE gather, then
reassembles the per-request row blocks through the inverse mapping. Link
traffic is bounded by the *unique cold* rows of a batch, not by the rows
requested.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.serve.cache import HotRowCache


class RequestBatcher:
    def __init__(self, gather: Callable[[np.ndarray], np.ndarray],
                 cache: HotRowCache):
        self.gather = gather          # uniq ids -> float32 [n, d] from pool
        self.cache = cache

    def lookup_batch(self, requests: Sequence) -> list[np.ndarray]:
        """requests: per-request id arrays. Returns the per-request row
        blocks, in order, each shaped ids.shape + (d,)."""
        reqs = [np.asarray(r, dtype=np.int64) for r in requests]
        if not reqs:
            return []
        flat = np.concatenate([r.reshape(-1) for r in reqs])
        uniq, inverse = np.unique(flat, return_inverse=True)
        rows = self._fetch_unique(uniq)
        batch = rows[inverse]         # ONE fancy-index for the whole batch
        out, pos = [], 0
        for r in reqs:
            n = r.size
            # each request's block is a zero-copy view into `batch`
            out.append(batch[pos:pos + n].reshape(r.shape
                                                  + (rows.shape[-1],)))
            pos += n
        return out

    def _fetch_unique(self, uniq: np.ndarray) -> np.ndarray:
        if uniq.size == 0:
            return np.empty((0, 0), np.float32)
        since = self.cache.epoch      # before the gather: see HotRowCache
        hits, missing = self.cache.get_many(uniq)
        fetched = None
        if missing:
            miss_ids = np.asarray(missing, dtype=np.int64)
            fetched = np.asarray(self.gather(miss_ids))
            self.cache.put_many(missing, fetched, since=since)
            if not hits:
                # all cold: the misses follow sorted uniq, so the gather's
                # block already is the answer
                return fetched
        some = fetched if fetched is not None else next(iter(hits.values()))
        out = np.empty((uniq.size, some.shape[-1]), dtype=some.dtype)
        if fetched is not None:
            # uniq is sorted: one vectorised scatter places every cold row
            out[np.searchsorted(uniq, miss_ids)] = fetched
        if hits:
            hit_ids = np.fromiter(hits, dtype=np.int64, count=len(hits))
            for j, row in zip(np.searchsorted(uniq, hit_ids),
                              hits.values()):
                out[j] = row          # cached views copy once, into `out`
        return out
