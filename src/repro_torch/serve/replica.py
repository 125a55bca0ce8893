"""Serving reads from a read-replica domain of a sharded pool (counterpart
of ``repro.serve.replica``).

``ShardedPool.replicate_domain`` leaves a pinned, refresh-on-commit copy of
the embedding mirror under ``<domain>@replica`` on another node. This reader
resolves those regions through the normal (proxy-mode) allocator — so its
Region handles carry global offsets that route every ``gather`` straight to
the replica's node — and exposes the bounded-lag watermark the refresher
stamped. Because the routing is by offset, reads keep working while the
PRIMARY shard is down: nothing on this path ever touches the source node.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.pool.allocator import JsonRegion, PoolAllocator, Region
from repro_torch.pool.device import PoolDevice, PoolError
from repro_torch.pool.nmp import NmpQueue
from repro_torch.pool.sharded import replica_domain


class ReplicaReader:
    def __init__(self, pool: PoolDevice, domain: str = "embedding-mirror",
                 name: str = "rows"):
        self.pool = pool
        self.domain_name = replica_domain(domain)
        self.name = name
        self.alloc = PoolAllocator(pool)
        self.nmp = NmpQueue(pool)
        self.region: Optional[Region] = None
        self._wm: Optional[JsonRegion] = None
        self.refresh()

    def refresh(self) -> bool:
        """(Re)resolve the replica's region handles — after the first
        refresh lands, or after a reconnect. ONE directory listing
        resolves both the rows region and the watermark (it used to be a
        ``get`` round trip per handle). Returns True if the replica
        exists."""
        regs = self.alloc.domain(self.domain_name).regions()
        self.region = regs.get(self.name)
        wm = regs.get("watermark")
        self._wm = None if wm is None else JsonRegion(wm)
        return self.region is not None

    @property
    def ready(self) -> bool:
        return self.region is not None or self.refresh()

    def _revalidate(self):
        """A refresh that RE-ALLOCATED the replica regions (shape growth,
        ring turnover) leaves this reader's cached handles pointing at
        freed bytes — a gather there serves garbage, or is a
        use-after-free. One directory probe per read compares the
        cached entry's offset/extent against the live directory and rebinds
        BOTH handles (rows + watermark) when the entry moved."""
        if self.region is None:
            return
        try:
            cur = self.alloc.domain(self.domain_name).get(self.name)
        except PoolError:
            cur = None
        if cur is None or cur.off != self.region.off \
                or cur.nbytes != self.region.nbytes:
            self.refresh()

    def watermark(self) -> int:
        """The committed trainer step this replica reflects (-1 = never
        stamped). Serving staleness is bounded by (latest commit − this)."""
        self._revalidate()
        if self._wm is None and not self.refresh():
            return -1
        if self._wm is None:
            return -1
        return int((self._wm.read() or {}).get("step", -1))

    def gather(self, idx) -> np.ndarray:
        if not self.ready:
            raise PoolError(f"replica {self.domain_name!r} not materialised")
        self._revalidate()
        if self.region is None:
            raise PoolError(f"replica {self.domain_name!r} vanished")
        return self.nmp.gather(self.region, np.asarray(idx).reshape(-1))

    def bag_gather(self, idx, combine: str = "sum") -> np.ndarray:
        if not self.ready:
            raise PoolError(f"replica {self.domain_name!r} not materialised")
        self._revalidate()
        if self.region is None:
            raise PoolError(f"replica {self.domain_name!r} vanished")
        return self.nmp.bag_gather(self.region, idx, combine=combine)
