"""Byte-addressable pool backends behind one ``PoolDevice`` API (counterpart
of ``repro.pool.device``).

The emulation models the paper's two-level persistence pipeline explicitly:

    host/NMP writes  ->  volatile device cache  --persist-->  durable media

``write``/``view`` mutate the *cache* (fast, volatile: CPU caches plus the
PMEM write-pending queue). ``persist(point=...)`` is the explicit
flush/fence barrier that copies dirty ranges to *media*; only persisted
bytes survive ``crash()``. ``DramPool`` keeps media in a second host buffer
(a battery-backed DIMM image, recoverable in-process only); ``PmemPool``
maps a file, so a killed process recovers from disk exactly like a
power-cycled PMEM module (``PmemPool.open``). The image is byte-identical to
the JAX package's, so either package recovers the other's checkpoints.

Every access records (bytes, modeled latency) into ``PoolMetrics`` using the
Table-2 device profiles, and every persist barrier is a named fault point
(``faults.py``): a schedule can drop it, tear it mid-range, or crash
before/after it.

``make_pool("remote", addr=...)`` connects to a memory node in another
process (``repro_torch.pool.server``) through ``remote.RemotePool``;
``make_pool("sharded", shards=...)`` puts several nodes behind a placement
map (``sharded.ShardedPool``). ``check=True``, or ``REPRO_POOL_CHECK=1``
in the environment, wraps any of them in the crash-consistency checker
(``repro_torch.analysis.checker.CheckedPool``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from repro_torch.pool.faults import FaultSchedule, InjectedCrash
from repro_torch.pool.metrics import PoolMetrics
from repro_torch.sim import devices as dv


class PoolError(RuntimeError):
    """Base class for every pool-layer failure (all subtypes are typed, so
    callers and the wire protocol can tell them apart)."""


class QuotaExceededError(PoolError):
    """A tenant's allocation would exceed its byte quota."""


class TenantIsolationError(PoolError):
    """A tenant addressed bytes (or a domain) it does not own, or a
    readonly allocator or connection asked to allocate, free or write."""


class PoolDevice:
    """Common cache/media/dirty-range machinery; subclasses provide media."""

    profile: dv.MemDevice = dv.DRAM

    def __init__(self, capacity: int, faults: Optional[FaultSchedule] = None):
        capacity = max(int(capacity), 1 << 16)
        self._cache = np.zeros(capacity, dtype=np.uint8)
        self._dirty: list[list[int]] = []     # [start, end), merged at persist
        self.faults = faults
        self.metrics = PoolMetrics(device_name=self.profile.name)
        self.closed = False

    # -- subclass media interface -------------------------------------------
    def _media_read_all(self) -> np.ndarray:
        raise NotImplementedError

    def _media_write(self, start: int, data: np.ndarray):
        raise NotImplementedError

    def _media_sync(self):
        pass

    def _media_grow(self, new_capacity: int):
        raise NotImplementedError

    # -- geometry ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._cache.size

    def ensure(self, nbytes: int):
        """Grow cache+media so that offsets < nbytes are addressable."""
        if nbytes <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < nbytes:
            new_cap *= 2
        self._media_grow(new_cap)
        grown = np.zeros(new_cap, dtype=np.uint8)
        grown[:self._cache.size] = self._cache
        self._cache = grown

    # -- cache access --------------------------------------------------------
    def _check(self, off: int, nbytes: int):
        if self.closed:
            raise PoolError("device closed")
        if off < 0 or off + nbytes > self.capacity:
            raise PoolError(f"access [{off}, {off + nbytes}) beyond capacity "
                            f"{self.capacity}")

    def read(self, off: int, nbytes: int, tag: str = "read") -> np.ndarray:
        """Read-only view of cache bytes (coherent: sees unpersisted writes)."""
        self._check(off, nbytes)
        self.metrics.record(tag, nbytes, self.profile.t_bulk_read(nbytes))
        v = self._cache[off:off + nbytes]
        v.flags.writeable = False
        return v

    def write(self, off: int, data, tag: str = "write"):
        if isinstance(data, (bytes, bytearray, memoryview)):
            data = np.frombuffer(data, dtype=np.uint8)
        else:
            data = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        self._check(off, data.size)
        self._cache[off:off + data.size] = data
        self.mark_dirty(off, data.size)
        self.metrics.record(tag, data.size,
                            self.profile.t_bulk_write(data.size))

    def view(self, off: int, nbytes: int) -> np.ndarray:
        """Writable cache view for zero-copy near-memory ops. The caller must
        ``mark_dirty`` what it mutates and account its own traffic."""
        self._check(off, nbytes)
        return self._cache[off:off + nbytes]

    # -- async / scatter-gather forms ----------------------------------------
    # Local devices resolve these at once; RemotePool overrides them with
    # pipelined futures and single-round-trip batch frames.
    def read_async(self, off: int, nbytes: int, tag: str = "read"):
        from repro_torch.pool.protocol import CompletedFuture
        return CompletedFuture(self.read(off, nbytes, tag=tag))

    def write_async(self, off: int, data, tag: str = "write"):
        from repro_torch.pool.protocol import CompletedFuture
        self.write(off, data, tag=tag)
        return CompletedFuture(None)

    def read_batch(self, reqs, tag: str = "read") -> list:
        """[(off, nbytes), ...] -> [bytes, ...], each read charged as
        ``read`` charges it (one round trip on a remote pool)."""
        return [bytes(self.read(off, nbytes, tag=tag))
                for off, nbytes in reqs]

    def nmp_batch(self, calls) -> list:
        """[(kind, region, kwargs), ...] run through the protocol's op
        registry: in order here, as ONE scatter-gather frame remotely."""
        from repro_torch.pool.nmp import NmpQueue
        from repro_torch.pool.protocol import NMP_OPS
        q = NmpQueue(self)
        out = []
        for kind, region, kw in calls:
            spec = NMP_OPS.get(kind)
            if spec is None:
                raise PoolError(f"unknown nmp kind {kind!r}")
            out.append(spec.run(q, region, **kw))
        return out

    def mark_dirty(self, off: int, nbytes: int):
        # append-only on the hot path; ranges are sorted and merged at the
        # next persist (a DLRM step marks tens of thousands of rows)
        if nbytes > 0:
            self._dirty.append([off, off + nbytes])

    @staticmethod
    def _merge_ranges(ranges: list[list[int]]) -> list[list[int]]:
        if len(ranges) <= 1:
            return ranges
        ranges.sort()
        out = [ranges[0]]
        for s, e in ranges[1:]:
            if s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    # -- persistence barrier -------------------------------------------------
    def persist(self, off: Optional[int] = None, nbytes: Optional[int] = None,
                point: str = "persist"):
        """Flush dirty ranges (optionally clipped to [off, off+nbytes)) to
        durable media. Honors the fault schedule at `point`."""
        action = "ok"
        if self.faults is not None:
            action = self.faults.hit(point)      # may raise InjectedCrash
        lo = 0 if off is None else off
        hi = self.capacity if nbytes is None else lo + nbytes
        self._dirty = self._merge_ranges(self._dirty)
        todo, keep = [], []
        for s, e in self._dirty:
            cs, ce = max(s, lo), min(e, hi)
            if cs < ce:
                todo.append((cs, ce))
                if s < cs:
                    keep.append([s, cs])
                if ce < e:
                    keep.append([ce, e])
            else:
                keep.append([s, e])
        self._dirty = keep

        if action == "drop":
            # the software *believes* this data is durable; media unchanged
            self.metrics.dropped_flushes += 1
            return
        total = 0
        for i, (s, e) in enumerate(todo):
            if action == "torn" and i == 0:
                half = s + max(1, (e - s) // 2)
                self._media_write(s, self._cache[s:half])
                self._media_sync()
                self.metrics.torn_writes += 1
                self.metrics.record("persist", half - s,
                                    self.profile.t_bulk_write(half - s))
                raise InjectedCrash(point, self.faults.counts.get(point, 0))
            self._media_write(s, self._cache[s:e])
            total += e - s
        self._media_sync()
        self.metrics.record("persist", total,
                            self.profile.t_bulk_write(max(total, 1)))
        if action == "crash-after":
            raise InjectedCrash(point, self.faults.counts.get(point, 0))

    # -- failure -------------------------------------------------------------
    def crash(self):
        """Power loss: the volatile cache is gone; reload the durable image."""
        self.metrics.crashes += 1
        media = self._media_read_all()
        self._cache = np.array(media, dtype=np.uint8)  # fresh copy
        self._dirty = []

    def close(self):
        self.closed = True


class DramPool(PoolDevice):
    """Volatile-backend pool: media is a second host buffer (think
    battery-backed DRAM). Survives in-process ``crash()`` but not process
    death; recovery across processes requires the pmem backend."""

    profile = dv.DRAM
    backend = "dram"

    def __init__(self, capacity: int = 1 << 20,
                 faults: Optional[FaultSchedule] = None):
        super().__init__(capacity, faults)
        self._media = np.zeros(self.capacity, dtype=np.uint8)

    def _media_read_all(self):
        return self._media

    def _media_write(self, start, data):
        self._media[start:start + data.size] = data

    def _media_grow(self, new_capacity):
        grown = np.zeros(new_capacity, dtype=np.uint8)
        grown[:self._media.size] = self._media
        self._media = grown


class PmemPool(PoolDevice):
    """File-backed persistent pool: media is an mmap'd file; ``persist`` is
    flush + fsync, so recovery works across process death."""

    profile = dv.PMEM
    backend = "pmem"

    def __init__(self, path: str, capacity: int = 1 << 20,
                 faults: Optional[FaultSchedule] = None, _existing=False):
        self.path = path
        if _existing:
            capacity = os.path.getsize(path)
        else:
            cap = max(int(capacity), 1 << 16)
            if not os.path.exists(path) or os.path.getsize(path) < cap:
                with open(path, "ab") as f:
                    f.truncate(cap)
            capacity = os.path.getsize(path)
        super().__init__(capacity, faults)
        self._fd = os.open(path, os.O_RDWR)
        self._mm = np.memmap(path, dtype=np.uint8, mode="r+",
                             shape=(capacity,))
        # cache starts from the durable image (coherent after reopen)
        self._cache[:] = self._mm

    @classmethod
    def open(cls, path: str,
             faults: Optional[FaultSchedule] = None) -> "PmemPool":
        if not os.path.exists(path):
            raise PoolError(f"no pool image at {path}")
        return cls(path, faults=faults, _existing=True)

    def _media_read_all(self):
        return self._mm

    def _media_write(self, start, data):
        self._mm[start:start + data.size] = data

    def _media_sync(self):
        self._mm.flush()
        os.fsync(self._fd)

    def _media_grow(self, new_capacity):
        self._mm.flush()
        del self._mm
        os.truncate(self.path, new_capacity)
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r+",
                             shape=(new_capacity,))

    def close(self):
        if not self.closed:
            self._mm.flush()
            os.close(self._fd)
        super().close()


BACKENDS = ("dram", "pmem", "remote", "sharded")


def check_backend(backend: str) -> str:
    """``backend`` if the port has it; raises for any other rather than
    running on another one."""
    if backend not in BACKENDS:
        raise PoolError(f"unknown pool backend {backend!r} (want one of "
                        f"{BACKENDS})")
    return backend


def make_pool(backend: str, *, path: Optional[str] = None,
              capacity: int = 1 << 20,
              faults: Optional[FaultSchedule] = None,
              addr: Optional[str] = None, tenant: str = "default",
              quota: int = 0, shards=None, placement=None,
              rebalance: float = 0.0, secret: str = "",
              readonly: bool = False, timeout=None, wire=None,
              check: Optional[bool] = None):
    """A dram or pmem pool (pmem needs the image ``path``), a tenant of
    the memory node at ``addr`` (remote), or a tenant of every node in
    ``shards`` (sharded: addresses, a list or one comma-separated string;
    ``placement`` pins domains, ``dom=idx,...`` or a dict; ``rebalance`` > 0
    arms the capacity-watermark rebalancer at that fill). ``timeout``
    (remote and sharded): a float rescales the per-op-class wire deadlines
    around it, a ``protocol.Timeouts`` pins them; None keeps the registry's
    defaults. ``wire`` pins the protocol revision to offer (1, 2 or 3);
    None honours ``REPRO_POOL_WIRE`` and otherwise asks for v3. ``check``
    wraps the device in the crash-consistency checker; None honours
    ``REPRO_POOL_CHECK`` (off the default path otherwise)."""
    check_backend(backend)
    if backend == "dram":
        return maybe_check(DramPool(capacity, faults), check)
    if backend == "pmem":
        if not path:
            raise PoolError("pmem backend needs a file path")
        return maybe_check(PmemPool(path, capacity, faults), check)
    if backend == "sharded":
        if not shards:
            raise PoolError("sharded backend needs shard addrs "
                            "(--pool-shards addr1,addr2,...)")
        from repro_torch.pool.placement import PlacementMap, RebalancePolicy
        from repro_torch.pool.sharded import ShardedPool
        pmap = PlacementMap.parse(shards, placement)
        dev = ShardedPool(list(pmap.shards), tenant=tenant, quota=quota,
                          placement=pmap, secret=secret, readonly=readonly,
                          timeout=timeout, wire=wire)
        if rebalance:
            dev.rebalance = RebalancePolicy(high=float(rebalance))
    else:
        if not addr:
            raise PoolError("remote backend needs a server addr "
                            "(unix:/path or tcp:host:port)")
        from repro_torch.pool.remote import RemotePool
        dev = RemotePool(addr, tenant=tenant, quota=quota, secret=secret,
                         readonly=readonly, timeout=timeout, wire=wire)
    if faults is not None:
        dev.faults = faults
    return maybe_check(dev, check)


def maybe_check(dev: PoolDevice, check: Optional[bool] = None):
    """``dev`` wrapped in the crash-consistency checker when asked to,
    explicitly or (``check=None``) through ``REPRO_POOL_CHECK``."""
    from repro_torch.analysis.checker import CheckedPool, checking_enabled
    if check is None:
        check = checking_enabled()
    return CheckedPool(dev) if check else dev
