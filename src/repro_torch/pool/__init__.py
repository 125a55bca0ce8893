"""repro_torch.pool — the emulated CXL/PMEM memory pool (counterpart of
``repro.pool``).

Layering (bottom up):
  device.py     byte-addressable backends (DramPool / PmemPool) with explicit
                persist barriers, crash semantics, and Table-2 accounting
  allocator.py  named persistence domains, crash-atomic directory, JsonRegion,
                tenant namespaces + byte quotas + owned ranges, readonly
                openers (the serving tier)
  compress.py   pool-side compression codecs (zlib / int8) + framed blobs
  undo_codec.py undo-log slot format
  nmp.py        near-memory ops (gather / bag-reduce / scatter-add / row
                update / undo snapshot / fused undo-log append / ring scan
                and GC / compressed blob put / region export and import)
                + EmbeddingPoolMirror
  faults.py     deterministic crash / torn-write / dropped-flush injection
  metrics.py    traffic + energy counters, snapshots for the wire
  protocol.py   the wire protocol: framing, versioned hello (v1/v2/v3),
                typed op registry (OPS / NMP_OPS), error transparency,
                per-op-class timeouts, scatter-gather batch frames, and the
                pipelined PoolChannel
  remote.py     RemotePool client over a PoolChannel (HMAC shared-secret
                handshake on tcp), splitting reads and writes above one
                frame's worth
  server.py     the memory node: one process serving many trainer tenants
  placement.py  epoch-versioned PlacementMap (domain -> shard, CRC-sealed
                move records) + capacity-watermark RebalancePolicy
  sharded.py    ShardedPool: N memory nodes behind one device, placement-
                routed domain ops, live migration, read replicas and
                promotion after a node's loss, per-shard fault drills,
                merged and per-shard metrics

Every byte these modules write, and every frame they send, is the JAX
package's, so a pool image or a memory node made by either package serves
the other.
"""
from repro_torch.pool.allocator import JsonRegion, PoolAllocator, Region
from repro_torch.pool.device import (BACKENDS, DramPool, PmemPool, PoolDevice,
                                     PoolError, QuotaExceededError,
                                     TenantIsolationError, make_pool)
from repro_torch.pool.faults import FaultEvent, FaultSchedule, InjectedCrash
from repro_torch.pool.metrics import PoolMetrics
from repro_torch.pool.nmp import EmbeddingPoolMirror, NmpQueue
from repro_torch.pool.placement import (Migration, PlacementEpoch,
                                        PlacementMap, PoolTopology,
                                        RebalancePolicy)
from repro_torch.pool.protocol import (NMP_OPS, OPS, WIRE_V1, WIRE_V2,
                                       WIRE_V3, PoolChannel,
                                       PoolTimeoutError, Timeouts,
                                       wire_from_env)
from repro_torch.pool.remote import (PoolAuthError, PoolConnectionError,
                                     RemotePool, WireError, parse_addr)
from repro_torch.pool.sharded import (REPLICA_SUFFIX, ShardedPool,
                                      replica_domain)

__all__ = [
    "BACKENDS", "DramPool", "EmbeddingPoolMirror", "FaultEvent",
    "FaultSchedule", "InjectedCrash", "JsonRegion", "Migration", "NMP_OPS",
    "NmpQueue", "OPS", "PlacementEpoch", "PlacementMap", "PmemPool",
    "PoolAllocator", "PoolAuthError", "PoolChannel", "PoolConnectionError",
    "PoolDevice", "PoolError", "PoolMetrics", "PoolTimeoutError",
    "PoolTopology", "QuotaExceededError", "REPLICA_SUFFIX", "Region",
    "RebalancePolicy", "RemotePool", "ShardedPool", "TenantIsolationError",
    "Timeouts", "WIRE_V1", "WIRE_V2", "WIRE_V3", "WireError", "make_pool",
    "parse_addr", "replica_domain", "wire_from_env",
]
# "PoolServer" is importable too, through the lazy __getattr__ below


def __getattr__(name):
    # lazy, so that `python -m repro_torch.pool.server` does not trip
    # runpy's already-in-sys.modules warning
    if name == "PoolServer":
        from repro_torch.pool.server import PoolServer
        return PoolServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
