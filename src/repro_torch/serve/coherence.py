"""Commit-driven cache invalidation: tail the trainer's undo log
(counterpart of ``repro.serve.coherence``).

The serving tier never sees the trainer's writes directly, but every tier-E
commit leaves a durable record in the undo ring: the slot header carries
the step, the payload exactly the touched ``idx``. The tailer polls
``committed_after`` (ONE strided ``slot_headers`` near-memory read and one
batched payload read), and for each step newer than its watermark evicts
exactly those rows from the hot cache. No extra trainer-to-server channel,
no broadcast flush: invalidation is as precise as the undo log.

The tailer opens the ring READONLY (``open_ring(readonly=True)``): it must
never sweep, grow or GC the writer's ring.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.checkpoint.undo_log import UndoRing, open_ring
from repro_torch.pool.device import PoolDevice
from repro_torch.serve.cache import HotRowCache


class CommitTailer:
    def __init__(self, ring: UndoRing, cache: HotRowCache):
        self.ring = ring
        self.cache = cache
        self.watermark = -1

    @classmethod
    def attach(cls, device: PoolDevice, cache: HotRowCache) -> "CommitTailer":
        """Raises ``TenantIsolationError`` while the pool has no undo ring:
        a readonly opener may not create one. The ring's size is read from
        its meta."""
        return cls(open_ring(device, readonly=True), cache)

    def _rebind(self) -> bool:
        """The writer creates the ring lazily (first commit) and may grow it
        (generation flip) at any time: re-read meta and rebind the region
        handle whenever the generation moved. A meta read and a directory
        get, nothing else."""
        m = self.ring.meta.read()
        if m is None:
            return False
        if self.ring.ring is None or m["gen"] != self.ring.gen:
            self.ring.gen = m["gen"]
            self.ring.nslots = m["nslots"]
            self.ring.slot_bytes = m["slot_bytes"]
            self.ring.ring = self.ring.domain.get(f"ring{self.ring.gen}")
        return self.ring.ring is not None

    def poll(self) -> dict:
        """Evict the rows of every commit newer than the watermark. A slot
        the writer GC'd (or overwrote) between the scan and the read
        decodes to None: its rows are older than max_undo_logs steps, so
        the watermark moves past it."""
        if not self._rebind():
            return {"steps": 0, "evicted": 0, "watermark": self.watermark}
        recs = self.ring.committed_after(self.watermark)
        evicted = 0
        for step in sorted(recs):
            rec = recs[step]
            if rec is not None:
                idx, _old_rows, _old_acc = rec
                evicted += self.cache.invalidate(idx)
            self.watermark = step
        return {"steps": len(recs), "evicted": evicted,
                "watermark": self.watermark}


def make_commit_hook(cache: HotRowCache, tailer: Optional[CommitTailer] = None):
    """In-process fast path: a ``CheckpointManager.add_commit_hook``
    callback that evicts a commit's touched rows directly (the tailer's
    precision, no polling latency). Keeps the tailer's watermark in step so
    that a later poll does not evict again."""
    def hook(step: int, idx):
        cache.invalidate(idx)
        if tailer is not None and step > tailer.watermark:
            tailer.watermark = int(step)
    return hook
