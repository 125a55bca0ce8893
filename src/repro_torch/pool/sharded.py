"""Multi-node sharded pool: N memory nodes behind one ``PoolDevice``
(counterpart of ``repro.pool.sharded``; the same placement, offsets and
frames, so its nodes may be either package's).

``ShardedPool`` composes several backends (remote ``RemotePool`` clients or
in-process devices) into one device the rest of the stack uses unchanged.
The trick is a *global address space*: shard ``i`` owns the offset window
``[i * SHARD_SPAN, (i+1) * SHARD_SPAN)``, so every ``Region`` handed out by
the (proxy-mode) allocator carries a global offset that encodes its owning
shard. Raw ``read``/``write``/``persist`` and every near-memory op route by
offset; domain-level ops (alloc/get/free) route by *placement*. The wire-v2
scatter-gather forms (``read_batch``/``nmp_batch``) group their sub-ops per
owning node — one batch frame per remote node — and reassemble results in
call order.

Placement is an epoch-versioned ``PlacementMap`` (``pool/placement.py``):
deterministic by construction — a pure CRC32 hash of the domain name over
the shard count, overridable per domain with explicit pins — and versioned
by *placement epochs*, the numbered move records live migration appends.
The same (shards, pins, epochs) inputs always produce the same assignment,
across processes and across restarts (recovery must never re-place or
re-hash a domain). ``undo-log`` aliases to ``embedding-mirror`` by default
so the fused ``undo_log_append`` op finds its mirror and its log slot on
the SAME node; migration preserves the invariant by moving the alias group
in one epoch. If a placement (or an explicit pin) does separate the two
regions of a fused op, the op degrades to a correct-but-chatty host-driven
path instead of failing.

Live migration (``migrate_domain``) streams a verbatim region-image copy to
the destination node via the ``region_export``/``region_import`` near-memory
ops (compressed frames, CRC over the stored bytes), then flips the
placement — appending an epoch and publishing it through ``epoch_sink`` in
one atomic write — and only then garbage-collects the source copy. Named
fault windows (``migrate.pre-copy``, ``migrate.mid-copy``,
``migrate.post-copy-pre-flip``, ``migrate.post-flip-pre-gc``) bracket every
step, so a crash anywhere recovers bit-identically to exactly one side of
the flip; ``sweep_stale_domains`` reclaims the copy the crash stranded
(by-name frees — the undo-ring grow pattern — so it can never double-free).

A domain never spans shards: its superblock entry, its regions, and all
their bytes live wholly inside the owning shard's own allocator directory.
Tenancy therefore stays per shard, and metrics stay attributable:
``metrics`` aggregates every shard's counters into one ``PoolMetrics``
while ``shard_metrics()`` keeps the per-node view — now including the
used/capacity gauges ``RebalancePolicy`` watermarks feed on.

Fault injection and power events are per shard: ``crash_shard(i)`` /
``set_shard_faults(i, schedule)`` drill one node while the others keep
serving; the plain ``crash()``/``faults`` forms fan out to every shard
(the all-nodes power event).

Permanent node loss is survivable, not just restart: ``replicate_domain``
keeps a pinned ``@replica`` copy fresh, ``ship_slot`` write-couples single
committed undo slots into that copy (bounded lag in committed steps, not
wall time), and ``promote_replica`` re-points placement at the replica in
ONE epoch flip when the primary shard is declared lost — the dead source is
never GC'd (it no longer answers); if it ever reappears, its stale copy is
reclaimed by ``sweep_stale_domains``. A pool opened with
``allow_unreachable=True`` tolerates members that no longer dial: every op
that would touch the lost node raises a typed ``PoolConnectionError``
while the surviving shards keep serving.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.pool.allocator import JsonRegion, Region
from repro_torch.pool.device import PoolDevice, PoolError, make_pool
from repro_torch.pool.faults import FaultSchedule, InjectedCrash
from repro_torch.pool.metrics import OpStat, PoolMetrics
from repro_torch.pool.nmp import NmpQueue
from repro_torch.pool.placement import (Migration, PlacementMap, PoolTopology,
                                  RebalancePolicy)
from repro_torch.pool.protocol import NMP_OPS, PoolConnectionError
from repro_torch.pool.remote import chunk_bytes

__all__ = ["PROMOTE_WINDOWS", "REPLICA_SUFFIX", "SHARD_SPAN", "Migration",
           "PlacementMap", "PoolTopology", "RebalancePolicy", "ShardedPool",
           "merge_metrics", "region_pieces", "replica_domain"]

# Each shard's offset window in the global address space. Large enough that
# no single emulated node ever grows past it; small enough that global
# offsets stay exact python ints (they are never packed into float64).
SHARD_SPAN = 1 << 44

# The migration windows, in protocol order (also the crash-matrix axis).
MIGRATE_WINDOWS = ("migrate.pre-copy", "migrate.mid-copy",
                   "migrate.post-copy-pre-flip", "migrate.post-flip-pre-gc")

# Read-replica copies live under this suffix: ``embedding-mirror@replica``
# is a pinned, refresh-on-commit copy of ``embedding-mirror`` on another
# node. The replica refresh windows mirror the migration ones so fault
# drills can kill either side mid-refresh.
REPLICA_SUFFIX = "@replica"
REPLICA_WINDOWS = ("replica.pre-copy", "replica.mid-copy",
                   "replica.post-copy")

# Promotion windows, in protocol order: a crash before the flip leaves the
# primary name still routed at the (lost) source — promotion simply reruns;
# a crash after it leaves the promoted copy authoritative.
PROMOTE_WINDOWS = ("promote.pre-copy", "promote.mid-copy",
                   "promote.post-copy-pre-flip", "promote.post-flip")


def replica_domain(domain: str) -> str:
    return domain + REPLICA_SUFFIX


def region_pieces(region: Region) -> list:
    """``region`` cut into byte ranges of at most ``remote.chunk_bytes()``
    (64 MiB), each a uint8 Region of its own over the same bytes.

    A region image moves between nodes as one ``region_export`` reply and
    one ``region_import`` request per piece. The JAX package sends each
    region as one of each, so a region above the 1 GiB frame cap (dlrm-rm1's
    2.56 GB mirror) cannot be replicated, promoted or migrated there. A node
    checks an nmp region against the tenant's owned byte ranges only, so
    either package's node exports and imports a piece as it would a
    region; each piece's frame carries its CRC over the stored bytes."""
    step = chunk_bytes()
    if region.nbytes <= step:
        return [region]
    return [dataclasses.replace(region, off=region.off + o,
                                nbytes=min(step, region.nbytes - o),
                                dtype="uint8",
                                shape=(min(step, region.nbytes - o),))
            for o in range(0, region.nbytes, step)]


class _DeadDevice:
    """Placeholder device for a member node that is permanently gone (the
    dial failed and the opener said ``allow_unreachable``). Every data,
    domain, and near-memory entry point raises the same typed
    ``PoolConnectionError`` — reads beyond the promoted replica's watermark
    fail loudly, never silently — while the attribute surface the shard
    fan-outs touch (``faults``, ``close``, metrics reset) stays inert so the
    surviving shards keep operating."""

    backend = "dead"
    remote = True
    capacity = 0

    def __init__(self, index: int, addr: str, err: str):
        self.index = index
        self.addr = addr
        self.err = err
        self.faults = None

    def _gone(self, *_a, **_k):
        raise PoolConnectionError(
            f"shard {self.index} permanently unreachable "
            f"({self.addr}): {self.err}")

    read = write = view = persist = _gone
    read_async = write_async = read_batch = _gone
    nmp = nmp_batch = mark_dirty = crash = _gone
    alloc_region = get_region = list_regions = _gone
    list_remote_domains = _gone
    free_remote_domain = free_remote_region = _gone
    metrics_snapshot = _gone

    def reset_metrics(self):
        pass

    def close(self):
        pass


class _Shard:
    """One member node: a device plus its domain-op surface. For a remote
    device the proxy ops go over the wire to the node's tenant-scoped
    allocator; for an in-process device a local ``PoolAllocator`` owns the
    node's directory (rebuilt on crash, exactly like the server does)."""

    def __init__(self, index: int, device: PoolDevice, tenant: str,
                 quota: int, readonly: bool = False):
        self.index = index
        self.device = device
        self.tenant = tenant
        self.quota = quota
        self.readonly = readonly
        self.remote = bool(getattr(device, "remote", False))
        if not self.remote:
            from repro_torch.pool.allocator import PoolAllocator
            self.alloc = PoolAllocator(device, tenant=tenant or None,
                                       quota=quota, readonly=readonly)
            self.nmp = NmpQueue(device)

    def rebuild(self):
        """After a power-cycle the in-process allocator view may be ahead of
        media — rebuild it from the durable directory (server parity)."""
        if not self.remote:
            from repro_torch.pool.allocator import PoolAllocator
            self.alloc = PoolAllocator(self.device, tenant=self.tenant or None,
                                       quota=self.quota,
                                       readonly=self.readonly)

    # -- domain ops (entry dicts, shard-local offsets) -----------------------
    def alloc_region(self, domain, name, shape, dtype, point) -> dict:
        if self.remote:
            return self.device.alloc_region(domain, name, shape, dtype, point)
        r = self.alloc._alloc(domain, name, shape, dtype, point)
        return {"off": r.off, "nbytes": r.nbytes, "dtype": r.dtype,
                "shape": list(r.shape)}

    def get_region(self, domain, name) -> Optional[dict]:
        if self.remote:
            return self.device.get_region(domain, name)
        r = self.alloc._get(domain, name)
        return None if r is None else {"off": r.off, "nbytes": r.nbytes,
                                       "dtype": r.dtype,
                                       "shape": list(r.shape)}

    def list_regions(self, domain) -> dict:
        if self.remote:
            return self.device.list_regions(domain)
        return {n: {"off": r.off, "nbytes": r.nbytes, "dtype": r.dtype,
                    "shape": list(r.shape)}
                for n, r in self.alloc._regions(domain).items()}

    def list_domains(self) -> list:
        if self.remote:
            return self.device.list_remote_domains()
        return self.alloc.tenant_domains()

    def free_domain(self, domain, point) -> bool:
        if self.remote:
            return self.device.free_remote_domain(domain, point)
        return self.alloc.free_domain(domain, point=point)

    def free_region(self, domain, name, point) -> bool:
        if self.remote:
            return self.device.free_remote_region(domain, name, point)
        return self.alloc._free_region(domain, name, point)

    def region(self, domain: str, name: str, ent: dict) -> Region:
        """Shard-local Region handle (offsets inside this node's device)."""
        return Region(self.device, domain, name, ent["off"], ent["nbytes"],
                      ent["dtype"], tuple(ent["shape"]))

    def queue(self) -> NmpQueue:
        """Near-memory dispatch against THIS node (local or over its wire)."""
        return self.nmp if not self.remote else NmpQueue(self.device)

    # -- metrics --------------------------------------------------------------
    def metrics_snapshot(self) -> dict:
        if self.remote:
            return self.device.metrics_snapshot()
        m = self.device.metrics
        m.used_bytes = self.alloc.used_bytes()      # capacity-watermark gauges
        m.capacity_bytes = self.device.capacity
        return m.snapshot()

    def reset_metrics(self):
        if self.remote:
            self.device.reset_metrics()
        else:
            self.device.metrics.reset()


def merge_metrics(snapshots: Sequence[dict],
                  device_name: str = "sharded") -> PoolMetrics:
    """Sum per-shard counter snapshots into one ``PoolMetrics`` view."""
    agg = PoolMetrics(device_name=device_name)
    for snap in snapshots:
        m = PoolMetrics.from_snapshot(snap)
        for side_a, side_m in ((agg.media, m.media), (agg.link, m.link)):
            for kind, s in side_m.items():
                t = side_a.setdefault(kind, OpStat())
                t.ops += s.ops
                t.nbytes += s.nbytes
                t.time_s += s.time_s
        agg.ndp_time_s += m.ndp_time_s
        agg.comp_raw_bytes += m.comp_raw_bytes
        agg.comp_stored_bytes += m.comp_stored_bytes
        agg.comp_time_s += m.comp_time_s
        for kind, (raw, stored) in m.comp.items():
            ent = agg.comp.setdefault(kind, [0, 0])
            ent[0] += raw
            ent[1] += stored
        agg.used_bytes += m.used_bytes
        agg.capacity_bytes += m.capacity_bytes
        agg.dropped_flushes += m.dropped_flushes
        agg.torn_writes += m.torn_writes
        agg.crashes += m.crashes
        agg.cache_hits += m.cache_hits
        agg.cache_misses += m.cache_misses
        agg.cache_invalidations += m.cache_invalidations
        agg.replica_refreshes += m.replica_refreshes
        agg.replica_bytes += m.replica_bytes
        agg.bytes_copied += m.bytes_copied
        agg.data_frames += m.data_frames
    return agg


class ShardedPool(PoolDevice):
    """One ``PoolDevice`` over N member nodes (the multi-node pool).

    ``shards`` may be node addresses (``unix:``/``tcp:`` strings — each
    becomes a ``RemotePool`` tenant connection) or already-open in-process
    ``PoolDevice`` instances (tests, dram drills). Mixing is allowed.
    """

    backend = "sharded"
    remote = True        # PoolAllocator must proxy domain ops through us

    def __init__(self, shards: Sequence, tenant: str = "default",
                 quota: int = 0, pin: Optional[dict] = None,
                 topology: Optional[PlacementMap] = None,
                 placement: Optional[PlacementMap] = None,
                 secret: str = "", readonly: bool = False,
                 timeout=None, wire=None, allow_unreachable: bool = False):
        placement = placement if placement is not None else topology
        if placement is None:
            addrs = [s if isinstance(s, str) else
                     getattr(s, "addr", f"<local:{i}>")
                     for i, s in enumerate(shards)]
            placement = PlacementMap(shards=tuple(addrs),
                                     pin=dict(pin or {}))
        if not shards:
            raise PoolError("sharded backend needs at least one shard")
        self.placement = placement
        self.tenant = tenant
        self.readonly = bool(readonly)
        self.closed = False
        self._faults: Optional[FaultSchedule] = None
        self._secret = secret
        self._timeout = timeout
        self._wire = wire
        # rebalancing hooks: a policy (attached by make_pool / the manager)
        # proposes migrations off the watermark gauges; the sink is the
        # durable half of the epoch flip (the manager points it at
        # POOL.json); the window hook lets drills act at a named window
        # (kill -9 a node mid-copy) without patching the protocol
        self.rebalance: Optional[RebalancePolicy] = None
        self.epoch_sink: Optional[Callable[[PlacementMap], None]] = None
        self.migrate_window_hook: Optional[Callable[[str], None]] = None
        self.allow_unreachable = bool(allow_unreachable)
        self.shards: list[_Shard] = []
        for i, spec in enumerate(shards):
            if isinstance(spec, str):
                try:
                    dev = make_pool("remote", addr=spec, tenant=tenant,
                                    quota=quota, secret=secret,
                                    readonly=self.readonly, timeout=timeout,
                                    wire=wire, check=False)
                except (PoolError, OSError) as e:
                    if not self.allow_unreachable:
                        raise
                    # permanent-loss posture: keep the index (placement is
                    # positional), serve typed connection errors for every
                    # op that would land there
                    dev = _DeadDevice(i, spec, str(e))
            else:
                dev = spec
            self.shards.append(_Shard(i, dev, tenant, quota,
                                      readonly=self.readonly))
        # fail fast on a policy that strands the fused op cross-shard
        # *silently*: an explicit pin (or an explicit single-domain move)
        # may separate mirror and log — the op falls back to the
        # host-driven path — but that is a choice the placement records,
        # never an accident of hashing
        if (self.placement.place("undo-log")
                != self.placement.place("embedding-mirror")
                and self.placement.explicit("undo-log") is None):
            raise PoolError("placement separates undo-log from "
                            "embedding-mirror without an explicit pin")

    @property
    def topology(self) -> PlacementMap:
        """The placement map (historic name, kept for callers that predate
        the epoch-versioned refactor)."""
        return self.placement

    # -- address space ---------------------------------------------------------
    @property
    def nshards(self) -> int:
        return len(self.shards)

    def shard_of(self, off: int) -> tuple[_Shard, int]:
        """Global offset -> (owning shard, shard-local offset)."""
        idx, local = divmod(int(off), SHARD_SPAN)
        if not 0 <= idx < self.nshards:
            raise PoolError(f"offset {off} outside every shard window")
        return self.shards[idx], local

    def _globalize(self, idx: int, ent: dict) -> dict:
        return {**ent, "off": int(ent["off"]) + idx * SHARD_SPAN}

    @property
    def capacity(self) -> int:
        return self.nshards * SHARD_SPAN

    def ensure(self, nbytes: int):
        pass        # growth is per shard, driven by each node's allocator

    # -- raw data path ---------------------------------------------------------
    def read(self, off: int, nbytes: int, tag: str = "read") -> np.ndarray:
        shard, local = self.shard_of(off)
        return shard.device.read(local, nbytes, tag=tag)

    def view(self, off: int, nbytes: int) -> np.ndarray:
        shard, local = self.shard_of(off)
        return shard.device.view(local, nbytes)

    def write(self, off: int, data, tag: str = "write"):
        shard, local = self.shard_of(off)
        shard.device.write(local, data, tag=tag)

    def read_async(self, off: int, nbytes: int, tag: str = "read"):
        shard, local = self.shard_of(off)
        return shard.device.read_async(local, nbytes, tag=tag)

    def write_async(self, off: int, data, tag: str = "write"):
        shard, local = self.shard_of(off)
        return shard.device.write_async(local, data, tag=tag)

    def read_batch(self, reqs, tag: str = "read") -> list:
        """Scatter-gather read across nodes: requests group by owning
        shard (ONE batch frame per remote node) and reassemble in request
        order."""
        out = [None] * len(reqs)
        groups: dict = {}
        for pos, (off, nbytes) in enumerate(reqs):
            shard, local = self.shard_of(off)
            groups.setdefault(shard.index,
                              (shard, []))[1].append((pos, local,
                                                      int(nbytes)))
        for shard, items in groups.values():
            blobs = shard.device.read_batch(
                [(local, n) for _, local, n in items], tag=tag)
            for (pos, _, _), blob in zip(items, blobs, strict=True):
                out[pos] = blob
        return out

    def nmp_batch(self, calls) -> list:
        """Batched near-memory ops routed per owning shard: each remote
        node gets ONE scatter-gather frame with its sub-ops (kept in call
        order per node); results return in the original call order.
        ``undo_log_append`` sub-ops take the singleton ``nmp`` path so the
        cross-shard fallback and slot_off globalisation still apply."""
        out = [None] * len(calls)
        groups: dict = {}
        for pos, (kind, region, kw) in enumerate(calls):
            if kind == "undo_log_append":
                out[pos] = self.nmp(kind, region, **kw)
                continue
            shard, local = self.shard_of(region.off)
            lr = self._localize_region(region, shard, local)
            groups.setdefault(shard.index,
                              (shard, []))[1].append((pos, kind, lr, kw))
        for shard, items in groups.values():
            res = shard.device.nmp_batch(
                [(kind, lr, kw) for _, kind, lr, kw in items])
            for (pos, _, _, _), r in zip(items, res, strict=True):
                out[pos] = r
        return out

    def mark_dirty(self, off: int, nbytes: int):
        if nbytes > 0:
            shard, local = self.shard_of(off)
            shard.device.mark_dirty(local, nbytes)

    def persist(self, off: Optional[int] = None,
                nbytes: Optional[int] = None, point: str = "persist"):
        if off is None:
            for shard in self.shards:      # global barrier: every node
                shard.device.persist(point=point)
            return
        shard, local = self.shard_of(off)
        shard.device.persist(local, nbytes, point=point)

    # -- power events / faults -------------------------------------------------
    def crash(self):
        """All-nodes power event (the correlated-failure drill)."""
        for i in range(self.nshards):
            self.crash_shard(i)

    def crash_shard(self, i: int):
        shard = self.shards[i]
        shard.device.crash()
        shard.rebuild()

    def dead_shards(self) -> list[int]:
        """Indices of members declared permanently lost at open time."""
        return [i for i, s in enumerate(self.shards)
                if getattr(s.device, "backend", "") == "dead"]

    def reconnect_shard(self, i: int):
        """Re-dial shard ``i`` after its node restarted (the old client
        connection is fenced after any mid-exchange transport failure)."""
        addr = self.placement.shards[i] if i < len(self.placement.shards) \
            else None
        if not isinstance(addr, str) or addr.startswith("<local"):
            raise PoolError(f"shard {i} has no reconnectable address")
        old = self.shards[i]
        try:
            old.device.close()
        except PoolError:
            pass
        dev = make_pool("remote", addr=addr, tenant=self.tenant,
                        quota=old.quota, secret=self._secret,
                        readonly=self.readonly, timeout=self._timeout,
                        wire=self._wire, check=False)
        self.shards[i] = _Shard(i, dev, self.tenant, old.quota,
                                readonly=self.readonly)

    @property
    def faults(self) -> Optional[FaultSchedule]:
        return self._faults

    @faults.setter
    def faults(self, schedule: Optional[FaultSchedule]):
        # fan out to every node: each shard counts its own occurrences (a
        # point fires on the n-th hit at the node that serves it). The
        # pool-level copy serves the migration windows and the cross-shard
        # fallback path, which execute here, not inside any one node.
        for shard in self.shards:
            if shard.remote:
                shard.device.faults = schedule
            else:
                shard.device.faults = schedule if schedule is None else \
                    FaultSchedule(events=schedule.events)
        self._faults = schedule

    def set_shard_faults(self, i: int, schedule: Optional[FaultSchedule]):
        """Arm (or clear) a schedule on ONE node — the partial-failure
        drills: a torn write or power loss on a single memory node."""
        self.shards[i].device.faults = schedule

    def close(self):
        if not self.closed:
            self.closed = True
            for shard in self.shards:
                try:
                    shard.device.close()
                except PoolError:
                    pass

    # -- metrics ---------------------------------------------------------------
    @property
    def metrics(self) -> PoolMetrics:
        return merge_metrics([s for s in self.shard_metrics()
                              if not s.get("unreachable")])

    def shard_metrics(self) -> list[dict]:
        """Per-node counter snapshots, index-aligned with the placement. A
        node that cannot be reached (killed, partitioned, fenced) yields
        ``{"unreachable": True, ...}`` instead of failing the whole view —
        the surviving shards' counters must stay observable mid-drill."""
        out = []
        for s in self.shards:
            try:
                out.append(s.metrics_snapshot())
            except PoolError as e:
                out.append({"unreachable": True, "error": str(e)})
        return out

    def metrics_snapshot(self, scope: str = "tenant") -> dict:
        if scope == "shards":
            return {str(i): snap
                    for i, snap in enumerate(self.shard_metrics())}
        return self.metrics.snapshot()

    def reset_metrics(self):
        for shard in self.shards:
            shard.reset_metrics()

    def wire_stats(self) -> dict:
        """Per-node transport counters for the remote members (negotiated
        wire revision, tx/rx bytes, keepalives, timeouts), keyed by shard
        index."""
        return {str(s.index): s.device.wire_stats() for s in self.shards
                if s.remote and hasattr(s.device, "wire_stats")}

    def latency_stats(self) -> dict:
        """Per-node client-observed op latency percentiles."""
        return {str(s.index): s.device.latency_stats()
                for s in self.shards
                if s.remote and hasattr(s.device, "latency_stats")}

    # -- allocator proxy (PoolAllocator routes through these) ------------------
    def alloc_region(self, domain: str, name: str, shape, dtype: str,
                     point: str = "superblock") -> dict:
        i = self.placement.place(domain)
        ent = self.shards[i].alloc_region(domain, name, shape, dtype, point)
        return self._globalize(i, ent)

    def get_region(self, domain: str, name: str) -> Optional[dict]:
        i = self.placement.place(domain)
        ent = self.shards[i].get_region(domain, name)
        return None if ent is None else self._globalize(i, ent)

    def list_regions(self, domain: str) -> dict:
        i = self.placement.place(domain)
        return {n: self._globalize(i, e)
                for n, e in self.shards[i].list_regions(domain).items()}

    def free_remote_domain(self, domain: str,
                           point: str = "superblock") -> bool:
        return self.shards[self.placement.place(domain)] \
            .free_domain(domain, point)

    def free_remote_region(self, domain: str, name: str,
                           point: str = "superblock") -> bool:
        return self.shards[self.placement.place(domain)] \
            .free_region(domain, name, point)

    # -- live migration --------------------------------------------------------
    def _hit(self, point: str):
        """Named migration window: drills may act here (window hook), and a
        pool-level fault schedule may crash here — both sides of every
        window are part of the recovery contract."""
        if self.migrate_window_hook is not None:
            self.migrate_window_hook(point)
        f = self._faults
        if f is not None and f.hit(point) == "crash-after":
            raise InjectedCrash(point, f.counts[point])

    def _alias_group(self, domain: str) -> list[str]:
        """The alias-complete move/promote unit — placement policy owns
        the co-location rule (``PlacementMap.group``)."""
        return self.placement.group(domain)

    def _copy_region(self, src_q: NmpQueue, src: Region, dst_q: NmpQueue,
                     dst_region: Callable[[], Region], compress: str,
                     window: str, point: str) -> int:
        """Copy one region image verbatim, piece by piece
        (``region_pieces``): the first piece's export, then the named
        mid-copy window, then ``dst_region()`` (the destination's alloc),
        then the pieces' imports, each piece exported just before its
        import. Returns the frames' bytes (the link bytes)."""
        pieces = region_pieces(src)
        frame = src_q.region_export(pieces[0], compress=compress)
        self._hit(window)
        dst = dst_region()
        link = 0
        for k, (sp, dp) in enumerate(zip(pieces, region_pieces(dst),
                                         strict=True)):
            if k:
                frame = src_q.region_export(sp, compress=compress)
            dst_q.region_import(dp, frame, point=point)
            link += len(frame)
        return link

    @staticmethod
    def _image_region(shard: _Shard, domain: str, name: str, ent: dict,
                      have: dict, gc_point: str, alloc_point: str) -> Region:
        """The region that receives an image of ``ent`` on ``shard``: the
        one ``have`` lists under ``name`` when its shape and dtype match (a
        refresh reuses it in place), else that one freed at ``gc_point``
        and a new one allocated at ``alloc_point`` (a same-name alloc under
        a changed shape would leak the old directory entry). Callers name
        both points as literals, so the lint sees where they fire."""
        dent = have.get(name)
        if dent is not None and (list(dent["shape"]) != list(ent["shape"])
                                 or dent["dtype"] != ent["dtype"]):
            shard.free_region(domain, name, gc_point)
            dent = None
        if dent is None:
            dent = shard.alloc_region(domain, name, tuple(ent["shape"]),
                                      ent["dtype"], alloc_point)
        return shard.region(domain, name, dent)

    def migrate_domain(self, domain: str, dst: int,
                       compress: str = "zlib") -> dict:
        """Move `domain` (and its co-located alias group) to shard `dst`:
        verbatim region-image copy (compressed frames, CRC over the stored
        bytes), then the atomic epoch flip, then source GC. A crash at any
        window leaves the domain wholly on exactly one side of the flip;
        the stranded copy is reclaimed by ``sweep_stale_domains``."""
        if not 0 <= dst < self.nshards:
            raise PoolError(f"migrate {domain!r}: destination shard {dst} "
                            f"out of range (have {self.nshards})")
        src = self.placement.place(domain)
        if src == dst:
            return {"epoch": self.placement.epoch, "moved": (), "src": src,
                    "dst": dst, "regions": 0, "link_bytes": 0,
                    "raw_bytes": 0}
        group = self._alias_group(domain)
        src_shard, dst_shard = self.shards[src], self.shards[dst]
        src_q, dst_q = src_shard.queue(), dst_shard.queue()
        self._hit("migrate.pre-copy")
        link_bytes = raw_bytes = nregions = 0
        for dom in group:
            ents = src_shard.list_regions(dom)
            for name in sorted(ents):
                ent = ents[name]
                link_bytes += self._copy_region(
                    src_q, src_shard.region(dom, name, ent), dst_q,
                    lambda: dst_shard.region(dom, name, dst_shard.alloc_region(
                        dom, name, tuple(ent["shape"]), ent["dtype"],
                        "migrate-alloc")),
                    compress, "migrate.mid-copy", "migrate-import")
                raw_bytes += int(ent["nbytes"])
                nregions += 1
        self._hit("migrate.post-copy-pre-flip")
        # THE flip: new epoch in memory, then one atomic durable publish.
        # Until the sink returns, recovery still reads the previous epoch
        # (domain on src, untouched); after it, the new one (domain on dst,
        # bit-identical image). There is no third state.
        self.placement = self.placement.with_epoch(
            {d: dst for d in group},
            reason=f"migrate {domain}: shard {src} -> {dst}")
        if self.epoch_sink is not None:
            self.epoch_sink(self.placement)
        self._hit("migrate.post-flip-pre-gc")
        for dom in group:
            src_shard.free_domain(dom, "migrate-gc")
        return {"epoch": self.placement.epoch, "moved": tuple(group),
                "src": src, "dst": dst, "regions": nregions,
                "link_bytes": link_bytes, "raw_bytes": raw_bytes}

    def replicate_domain(self, domain: str, dst: int,
                         compress: str = "zlib",
                         watermark: Optional[int] = None) -> dict:
        """Refresh (or create) the read replica of `domain` on shard `dst`:
        a verbatim region-image copy under ``<domain>@replica`` — same
        export/import machinery as migration, but the placement never flips
        and the source is never GC'd. The replica domain is pinned to `dst`
        (operator intent: the rebalancer never moves it, the open-time
        sweep never reclaims it) and the pin is published through
        ``epoch_sink`` so recovery keeps honoring it.

        ``watermark`` (the committed step this copy reflects) lands in a
        JsonRegion inside the replica domain AFTER every import persisted,
        so a crash mid-refresh leaves the replica claiming the PREVIOUS
        watermark over data that is at least that fresh — the staleness
        bound a serving fleet reads is always conservative. A primary that
        dies mid-refresh (export fails) leaves the replica intact at its
        old watermark; the declared lag bound is one refresh interval."""
        if not 0 <= dst < self.nshards:
            raise PoolError(f"replicate {domain!r}: destination shard {dst} "
                            f"out of range (have {self.nshards})")
        src = self.placement.place(domain)
        replica = replica_domain(domain)
        if self.placement.explicit(replica) != dst:
            self.placement = self.placement.with_pin(replica, dst)
            if self.epoch_sink is not None:
                self.epoch_sink(self.placement)
        src_shard, dst_shard = self.shards[src], self.shards[dst]
        src_q, dst_q = src_shard.queue(), dst_shard.queue()
        self._hit("replica.pre-copy")
        link_bytes = raw_bytes = nregions = 0
        ents = src_shard.list_regions(domain)
        have = dst_shard.list_regions(replica)
        # drop replica regions the source no longer lists (a retired
        # undo-ring generation, a renamed region): without this the replica
        # directory — and the shard's used_bytes gauge — creeps per refresh
        # until RebalancePolicy trips on a phantom fill
        for name in sorted(set(have) - set(ents) - {"watermark"}):
            dst_shard.free_region(replica, name, "replica-gc")
            have.pop(name, None)
        for name in sorted(ents):
            ent = ents[name]
            link_bytes += self._copy_region(
                src_q, src_shard.region(domain, name, ent), dst_q,
                lambda name=name, ent=ent: self._image_region(
                    dst_shard, replica, name, ent, have, "replica-gc",
                    "replica-alloc"),
                compress, "replica.mid-copy", "replica-import")
            raw_bytes += int(ent["nbytes"])
            nregions += 1
        self._hit("replica.post-copy")
        if watermark is not None:
            went = dst_shard.get_region(replica, "watermark")
            if went is None:
                went = dst_shard.alloc_region(replica, "watermark",
                                              (8 << 10,), "uint8",
                                              "replica-alloc")
            wm = JsonRegion(dst_shard.region(replica, "watermark", went))
            wm.write({"step": int(watermark)}, point="replica-watermark")
        return {"replica": replica, "src": src, "dst": dst,
                "regions": nregions, "link_bytes": link_bytes,
                "raw_bytes": raw_bytes,
                "watermark": watermark if watermark is not None else -1}

    def ship_slot(self, domain: str, name: str, slot_off: int,
                  buf: bytes) -> int:
        """Commit-coupled replication of ONE committed undo slot: the
        verbatim slot image (COMMIT word cleared) lands at the same slot
        offset inside the ``@replica`` copy's ring region, under the same
        two-barrier protocol the primary used (payload persist, then COMMIT
        persist — ``uc.write_slot``). The caller ships on every commit, so
        replica lag is bounded in committed steps, not wall time; only the
        slot bytes cross the link, never a full-domain refresh."""
        from repro_torch.pool import undo_codec as uc

        replica = replica_domain(domain)
        dst = self.placement.explicit(replica)
        if dst is None:
            raise PoolError(f"ship {domain!r}: no pinned replica domain "
                            f"{replica!r} — full-refresh it first")
        shard = self.shards[dst]
        ent = shard.get_region(replica, name)
        if ent is None:
            raise PoolError(f"ship {domain!r}: replica region {name!r} "
                            f"missing on shard {dst} — refresh out of date")
        if int(slot_off) + len(buf) > int(ent["nbytes"]):
            raise PoolError(f"ship {domain!r}: slot at {slot_off} overflows "
                            f"replica region {name!r}")
        self._hit("replica.commit-ship")
        uc.write_slot(shard.device, int(ent["off"]) + int(slot_off), buf)
        return len(buf)

    def promote_replica(self, domain: str, compress: str = "zlib",
                        from_domain: Optional[str] = None) -> dict:
        """Promote the replica copy of `domain` to primary after its shard
        was declared permanently lost: copy the pinned ``@replica`` (or,
        via `from_domain`, a quorum-witness) regions into the REAL domain
        name on the replica's own shard — local export/import, no wire to
        the dead node — then re-point placement in ONE epoch flip.

        The alias group moves together (promoting ``embedding-mirror``
        carries ``undo-log``), each member to its own replica's pinned
        shard. The lost source is never GC'd: it no longer answers, and if
        it ever reappears, placement no longer assigns it the domain so
        ``sweep_stale_domains`` reclaims the stale copy. A crash before the
        flip strands the promoted image under the real name on the replica
        shard — also swept, and promotion simply reruns; after the flip the
        promoted copy is authoritative and recovery replays the undo ring
        from it bit-identically up to the replication watermark."""
        group = [domain] if from_domain is not None \
            else self._alias_group(domain)
        srcs = {d: (from_domain if from_domain is not None
                    else replica_domain(d)) for d in group}
        moves = {}
        for d, src_dom in srcs.items():
            dst = self.placement.explicit(src_dom)
            if dst is None:
                raise PoolError(f"promote {d!r}: no pinned replica "
                                f"{src_dom!r} to promote")
            moves[d] = dst
        old = {d: self.placement.place(d) for d in group}
        self._hit("promote.pre-copy")
        link_bytes = raw_bytes = nregions = 0
        for d in group:
            shard = self.shards[moves[d]]
            q = shard.queue()
            ents = shard.list_regions(srcs[d])
            if not ents:
                raise PoolError(f"promote {d!r}: replica {srcs[d]!r} is "
                                f"empty on shard {moves[d]}")
            have = shard.list_regions(d)
            for name in sorted(ents):
                ent = ents[name]
                link_bytes += self._copy_region(
                    q, shard.region(srcs[d], name, ent), q,
                    lambda d=d, name=name, ent=ent, shard=shard:
                        self._image_region(shard, d, name, ent, have,
                                           "promote-gc", "promote-alloc"),
                    compress, "promote.mid-copy", "promote-import")
                raw_bytes += int(ent["nbytes"])
                nregions += 1
        self._hit("promote.post-copy-pre-flip")
        # THE flip: until the sink returns, recovery still routes the
        # domain at the lost shard (and retries promotion); after it, the
        # promoted copy is the domain. There is no third state.
        self.placement = self.placement.with_epoch(
            moves, reason=f"promote {domain}: replica replaces lost shard"
                          f"(s) {sorted(set(old.values()))}")
        if self.epoch_sink is not None:
            self.epoch_sink(self.placement)
        self._hit("promote.post-flip")
        return {"promoted": tuple(group), "epoch": self.placement.epoch,
                "src": old, "dst": moves, "regions": nregions,
                "link_bytes": link_bytes, "raw_bytes": raw_bytes}

    def sweep_stale_domains(self) -> list[tuple[str, int]]:
        """Open-time sweep: free any copy of a domain living on a shard the
        placement does not assign it to — the half-copy a crash-before-flip
        stranded on the destination, or the source image a crash between
        flip and GC leaked. Frees are by NAME against each node's own
        directory (the undo-ring grow pattern), so a copy already freed —
        by the crashed migration, or by a previous sweep — is a directory
        miss, never a double-free. Unreachable nodes are skipped; a later
        open sweeps them."""
        swept = []
        for i, shard in enumerate(self.shards):
            try:
                domains = shard.list_domains()
            except PoolError:
                continue
            for dom in domains:
                if self.placement.place(dom) != i \
                        and shard.free_domain(dom, "migrate-sweep"):
                    swept.append((dom, i))
        return swept

    def shard_domains(self, i: int) -> list:
        """Tenant-visible domains materialised on shard ``i`` (wherever the
        placement says they belong) — the sweep's and the policy's raw
        view."""
        return self.shards[i].list_domains()

    def domain_groups(self, i: int) -> list[tuple[str, tuple, int]]:
        """Alias-complete domain groups wholly placed on shard ``i`` with
        their byte sizes: ``[(lead, (members...), nbytes), ...]`` — the
        movable units ``RebalancePolicy`` chooses between."""
        try:
            doms = [d for d in self.shard_domains(i)
                    if self.placement.place(d) == i]
        except PoolError:
            return []
        out = []
        followers = self.placement.ALIAS
        for dom in sorted(doms):
            leader = followers.get(dom)
            if leader is not None and leader in doms:
                continue                     # rides with its leader
            group = [dom] + [f for f, ld in followers.items()
                             if ld == dom and f in doms]
            nbytes = sum(int(ent["nbytes"])
                         for g in group
                         for ent in self.shards[i].list_regions(g).values())
            out.append((dom, tuple(group), nbytes))
        return out

    # -- near-memory ops -------------------------------------------------------
    def _localize_region(self, region, shard: _Shard, local_off: int):
        """Rebind a global-offset Region to the owning shard's device."""
        return dataclasses.replace(region, device=shard.device,
                                   off=local_off)

    def nmp(self, kind: str, region, idx=None, rows=None, blob=None,
            combine: str = "sum", point: Optional[str] = None,
            log_region=None, **extra):
        """Route one near-memory op to the shard owning the target region,
        so near-memory execution stays near the right memory. The fused
        ``undo_log_append`` needs its mirror and its log slot on ONE node;
        when an explicit pin separates them it degrades to the host-driven
        two-region path (correct, but the undo image crosses the link)."""
        shard, local = self.shard_of(region.off)
        if kind == "undo_log_append":
            log_shard, log_local = self.shard_of(log_region.off)
            if log_shard is not shard:
                return self._cross_shard_undo_append(
                    region, log_region, idx=idx, rows=rows, point=point,
                    **extra)
            extra["slot_off"] = int(extra["slot_off"]) \
                - shard.index * SHARD_SPAN
            log_region = self._localize_region(log_region, log_shard,
                                               log_local)
        region = self._localize_region(region, shard, local)
        if shard.remote:
            return shard.device.nmp(kind, region, idx=idx, rows=rows,
                                    blob=blob, combine=combine, point=point,
                                    log_region=log_region, **extra)
        return self._local_nmp(shard, kind, region, idx=idx, rows=rows,
                               blob=blob, combine=combine, point=point,
                               log_region=log_region, **extra)

    @staticmethod
    def _local_nmp(shard: _Shard, kind, region, *, idx, rows, blob, combine,
                   point, log_region, **extra):
        # one op table: the same NMP_OPS descriptors the server and the
        # remote client use drive the local executors here
        spec = NMP_OPS.get(kind)
        if spec is None:
            raise PoolError(f"unknown nmp kind {kind!r}")
        return spec.run(shard.nmp, region, idx=idx, rows=rows, blob=blob,
                        combine=combine, point=point, log_region=log_region,
                        **extra)

    def _cross_shard_undo_append(self, mirror, log, *, idx, rows, point,
                                 step, slot_off, slot_bytes,
                                 compress="zlib"):
        """Pinned-apart fallback: same commit protocol, same fault points,
        but host-driven — the pre-update image crosses the link from the
        mirror shard and lands on the log shard. Chatty by design; the
        default placement never takes this path."""
        from repro_torch.pool import undo_codec as uc

        q = NmpQueue(self)           # routes each piece to its owner
        old = q.undo_snapshot(mirror, idx)
        buf, stored_len, raw_len = uc.pack_slot(step, idx, old, None,
                                                mode=compress,
                                                slot_bytes=slot_bytes)
        uc.write_slot(self, int(slot_off), buf)
        stats = {"stored": stored_len, "raw": raw_len}
        if rows is None:
            return stats
        f = self._shard_faults_for(mirror)
        if f is not None and \
                f.hit("tier_e.between-commit-and-apply") == "crash-after":
            raise InjectedCrash("tier_e.between-commit-and-apply",
                                f.counts["tier_e.between-commit-and-apply"])
        q.row_update(mirror, idx, rows, point=point or "mirror-apply")
        return stats

    def _shard_faults_for(self, region) -> Optional[FaultSchedule]:
        shard, _ = self.shard_of(region.off)
        return shard.device.faults if not shard.remote else self._faults
