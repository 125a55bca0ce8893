"""Traffic / energy accounting for the emulated memory pool (counterpart of
``repro.pool.metrics``).

Every ``PoolDevice`` access and every near-memory op records (bytes, modeled
seconds) under an op kind, split into *media* traffic (bytes moved inside the
pool: array accesses, undo snapshots, persist flushes) and *link* traffic
(bytes that cross the CXL link to the host: indices in, gathered rows or
reduced vectors out). The asymmetry between the two is the paper's headline
saving: near-memory capture keeps the undo images off the link, and the
near-memory bag reduction keeps the raw rows off it.

Energy follows the Fig. 13 model in ``sim/devices.POWER``: access energy =
device read/write power x modeled busy time, plus the near-memory adder
array, the compression engine, and link energy per busy second. The
serving tier's hot-row cache counts its hits, misses and invalidations
here too. A memory node keeps one ``PoolMetrics`` per tenant and ships it as
a ``snapshot()``; the tenant's client rebuilds it with ``from_snapshot``.
The wire counters (``bytes_copied``, ``data_frames``) count what crossed a
frame boundary by copy. The replica counters (``replica_refreshes``,
``replica_bytes``) count the sharded pool's read-replica refreshes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.sim import devices as dv

LINK_W = 5.0  # link power while busy (W)


@dataclass
class OpStat:
    ops: int = 0
    nbytes: int = 0
    time_s: float = 0.0

    def add(self, nbytes: int, time_s: float):
        self.ops += 1
        self.nbytes += int(nbytes)
        self.time_s += float(time_s)


@dataclass
class PoolMetrics:
    """Per-pool counters. Op kinds are free-form tags; conventional ones:
    read / write / persist (device layer), gather / bag_gather / scatter_add
    / row_update / undo_snapshot / undo_scan (nmp layer), link_in /
    link_out (host link)."""
    device_name: str = "dram"
    media: dict = field(default_factory=dict)     # kind -> OpStat
    link: dict = field(default_factory=dict)      # kind -> OpStat
    ndp_time_s: float = 0.0                       # near-memory compute busy
    comp_raw_bytes: int = 0                       # pool-side compression in
    comp_stored_bytes: int = 0                    # ...and what hit media
    comp_time_s: float = 0.0                      # compression engine busy
    comp: dict = field(default_factory=dict)      # kind -> [raw, stored]
    used_bytes: int = 0                           # capacity gauges: live
    capacity_bytes: int = 0                       # bytes / node capacity
    dropped_flushes: int = 0
    torn_writes: int = 0
    crashes: int = 0
    cache_hits: int = 0                           # serve-tier hot-row cache
    cache_misses: int = 0
    cache_invalidations: int = 0                  # rows evicted by commits
    replica_refreshes: int = 0                    # read-replica copy rounds
    replica_bytes: int = 0                        # ...and bytes they moved
    bytes_copied: int = 0                         # body bytes memcpy'd at the
    data_frames: int = 0                          # frame boundary / data ops

    def reset(self):
        """Zero the traffic counters (fault and crash tallies are kept),
        e.g. to measure steady-state steps without the mirror load."""
        self.media.clear()
        self.link.clear()
        self.ndp_time_s = 0.0
        self.comp_raw_bytes = 0
        self.comp_stored_bytes = 0
        self.comp_time_s = 0.0
        self.comp.clear()
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_invalidations = 0
        self.replica_refreshes = 0
        self.replica_bytes = 0
        self.bytes_copied = 0
        self.data_frames = 0

    def record_cache(self, hits: int = 0, misses: int = 0,
                     invalidations: int = 0):
        self.cache_hits += int(hits)
        self.cache_misses += int(misses)
        self.cache_invalidations += int(invalidations)

    def record_replica(self, nbytes: int):
        self.replica_refreshes += 1
        self.replica_bytes += int(nbytes)

    def cache_hit_rate(self) -> float:
        tot = self.cache_hits + self.cache_misses
        return self.cache_hits / tot if tot else 0.0

    def record(self, kind: str, nbytes: int, time_s: float):
        self.media.setdefault(kind, OpStat()).add(nbytes, time_s)

    def record_link(self, kind: str, nbytes: int,
                    link: dv.Link = dv.CXL_LINK):
        """Bytes across the host link, timed at ``link``'s rate."""
        self.link.setdefault(kind, OpStat()).add(nbytes, nbytes / link.bw)

    def record_ndp(self, flops: float):
        """Busy time of the near-memory adder array for ``flops`` adds."""
        self.ndp_time_s += flops / dv.NDP_LOGIC.flops

    def record_comp(self, raw_bytes: int, stored_bytes: int,
                    time_s: float = 0.0, kind: str = "undo"):
        """Pool-side (de)compression, tallied by payload kind ("undo" rows
        and "blob" snapshots compress very differently); busy time lands on
        the compression engine's own meter."""
        self.comp_raw_bytes += int(raw_bytes)
        self.comp_stored_bytes += int(stored_bytes)
        self.comp_time_s += float(time_s)
        ent = self.comp.setdefault(kind, [0, 0])
        ent[0] += int(raw_bytes)
        ent[1] += int(stored_bytes)

    def comp_ratio(self, kind: Optional[str] = None) -> float:
        """stored/raw (1.0 = off or unknown), for one payload kind or over
        everything pool-compressed when ``kind`` is None."""
        if kind is not None:
            raw, stored = self.comp.get(kind, (0, 0))
            return stored / raw if raw > 0 else 1.0
        if self.comp_raw_bytes <= 0:
            return 1.0
        return self.comp_stored_bytes / self.comp_raw_bytes

    # -- aggregates ----------------------------------------------------------
    def media_bytes(self, *kinds) -> int:
        """Media bytes of the given op kinds, or of every kind."""
        src = kinds or self.media.keys()
        return sum(self.media[k].nbytes for k in src if k in self.media)

    def link_bytes(self) -> int:
        return sum(s.nbytes for s in self.link.values())

    def media_time(self) -> float:
        return sum(s.time_s for s in self.media.values())

    def link_time(self) -> float:
        return sum(s.time_s for s in self.link.values())

    def energy(self) -> dict:
        """Joules by term, Fig. 13 power model, busy-time based."""
        P = dv.POWER
        if self.device_name == "pmem":
            read_t = sum(s.time_s for k, s in self.media.items()
                         if k in ("read", "gather", "bag_gather",
                                  "undo_snapshot", "undo_scan"))
            write_t = self.media_time() - read_t
            e_mem = P["pmem_read_w"] * read_t + P["pmem_write_w"] * write_t
        else:
            e_mem = P["dram_access_w"] * self.media_time()
        e = {
            "mem": e_mem,
            "ndp": P["ndp_logic_w"] * self.ndp_time_s,
            "comp": P["comp_engine_w"] * self.comp_time_s,
            "link": LINK_W * self.link_time(),
        }
        e["total"] = sum(e.values())
        return e

    @classmethod
    def from_snapshot(cls, snap: dict) -> "PoolMetrics":
        """Rebuild counters from a ``snapshot()`` dict: how a remote
        client materialises its tenant's counters on the node, so
        ``report()`` and ``energy()`` work unchanged."""
        m = cls(device_name=snap.get("device", "dram"))
        for side, table in (("media", m.media), ("link", m.link)):
            for kind, st in (snap.get(side) or {}).items():
                table[kind] = OpStat(ops=int(st["ops"]),
                                     nbytes=int(st["nbytes"]),
                                     time_s=float(st["time_s"]))
        m.ndp_time_s = float(snap.get("ndp_time_s", 0.0))
        m.comp_raw_bytes = int(snap.get("comp_raw_bytes", 0))
        m.comp_stored_bytes = int(snap.get("comp_stored_bytes", 0))
        m.comp_time_s = float(snap.get("comp_time_s", 0.0))
        m.comp = {k: [int(v[0]), int(v[1])]
                  for k, v in (snap.get("comp") or {}).items()}
        for key in ("used_bytes", "capacity_bytes", "dropped_flushes",
                    "torn_writes", "crashes", "cache_hits", "cache_misses",
                    "cache_invalidations", "replica_refreshes",
                    "replica_bytes", "bytes_copied", "data_frames"):
            setattr(m, key, int(snap.get(key, 0)))
        return m

    def snapshot(self) -> dict:
        """Every counter as plain JSON values (the ``metrics`` op's reply;
        the keys are the JAX package's)."""
        return {
            "device": self.device_name,
            "media": {k: vars(s) for k, s in self.media.items()},
            "link": {k: vars(s) for k, s in self.link.items()},
            "media_bytes": self.media_bytes(),
            "link_bytes": self.link_bytes(),
            "media_time_s": self.media_time(),
            "link_time_s": self.link_time(),
            "ndp_time_s": self.ndp_time_s,
            "comp_raw_bytes": self.comp_raw_bytes,
            "comp_stored_bytes": self.comp_stored_bytes,
            "comp_ratio": self.comp_ratio(),
            "comp_time_s": self.comp_time_s,
            "comp": {k: list(v) for k, v in self.comp.items()},
            "used_bytes": self.used_bytes,
            "capacity_bytes": self.capacity_bytes,
            "dropped_flushes": self.dropped_flushes,
            "torn_writes": self.torn_writes,
            "crashes": self.crashes,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_invalidations": self.cache_invalidations,
            "cache_hit_rate": self.cache_hit_rate(),
            "replica_refreshes": self.replica_refreshes,
            "replica_bytes": self.replica_bytes,
            "bytes_copied": self.bytes_copied,
            "data_frames": self.data_frames,
            "energy_j": self.energy(),
        }

    def report(self) -> str:
        lines = [f"pool[{self.device_name}] traffic/energy:"]
        for side, table in (("media", self.media), ("link", self.link)):
            for kind in sorted(table):
                s = table[kind]
                lines.append(f"  {side:5s} {kind:14s} ops={s.ops:<7d} "
                             f"bytes={s.nbytes:<12d} t={s.time_s * 1e3:.3f}ms")
        e = self.energy()
        lines.append(f"  link/media byte ratio: "
                     f"{self.link_bytes() / max(1, self.media_bytes()):.4f}")
        if self.comp_raw_bytes:
            lines.append(f"  pool compression: raw={self.comp_raw_bytes} "
                         f"stored={self.comp_stored_bytes} "
                         f"ratio={self.comp_ratio():.4f}")
        lines.append("  energy[J]: " + "  ".join(
            f"{k}={v:.6f}" for k, v in e.items()))
        if self.cache_hits or self.cache_misses or self.cache_invalidations:
            lines.append(f"  serve cache: hits={self.cache_hits} "
                         f"misses={self.cache_misses} "
                         f"inval={self.cache_invalidations} "
                         f"hit_rate={self.cache_hit_rate():.4f}")
        if self.replica_refreshes:
            lines.append(f"  replica: refreshes={self.replica_refreshes} "
                         f"bytes={self.replica_bytes}")
        if self.data_frames:
            lines.append(f"  wire: data_frames={self.data_frames} "
                         f"bytes_copied={self.bytes_copied}")
        if self.dropped_flushes or self.torn_writes or self.crashes:
            lines.append(f"  faults: dropped={self.dropped_flushes} "
                         f"torn={self.torn_writes} crashes={self.crashes}")
        return "\n".join(lines)
