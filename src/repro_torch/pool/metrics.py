"""Traffic / energy accounting for the emulated memory pool (counterpart of
``repro.pool.metrics``, local counters only).

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
here too. The JAX package's replica and wire counters serve its sharded and
remote pools and are not ported with it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
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
    dropped_flushes: int = 0
    torn_writes: int = 0
    crashes: int = 0
    cache_hits: int = 0                           # serve-tier hot-row cache
    cache_misses: int = 0
    cache_invalidations: int = 0                  # rows evicted by commits

    def record_cache(self, hits: int = 0, misses: int = 0,
                     invalidations: int = 0):
        self.cache_hits += int(hits)
        self.cache_misses += int(misses)
        self.cache_invalidations += int(invalidations)

    def cache_hit_rate(self) -> float:
        tot = self.cache_hits + self.cache_misses
        return self.cache_hits / tot if tot else 0.0

    def record(self, kind: str, nbytes: int, time_s: float):
        self.media.setdefault(kind, OpStat()).add(nbytes, time_s)

    def record_link(self, kind: str, nbytes: int):
        self.link.setdefault(kind, OpStat()).add(nbytes,
                                                 nbytes / dv.CXL_LINK.bw)

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

    def comp_ratio(self) -> float:
        """stored/raw over everything pool-compressed (1.0 = off)."""
        if self.comp_raw_bytes <= 0:
            return 1.0
        return self.comp_stored_bytes / self.comp_raw_bytes

    # -- aggregates ----------------------------------------------------------
    def media_bytes(self) -> int:
        return sum(s.nbytes for s in self.media.values())

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
        if self.dropped_flushes or self.torn_writes or self.crashes:
            lines.append(f"  faults: dropped={self.dropped_flushes} "
                         f"torn={self.torn_writes} crashes={self.crashes}")
        return "\n".join(lines)
