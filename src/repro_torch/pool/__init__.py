"""repro_torch.pool — the emulated CXL/PMEM memory pool (counterpart of
``repro.pool``, local backends only).

Layering (bottom up):
  device.py     byte-addressable backends (DramPool / PmemPool) with explicit
                persist barriers, crash semantics, and Table-2 accounting
  allocator.py  named persistence domains, crash-atomic directory, JsonRegion,
                readonly openers (the serving tier)
  compress.py   pool-side compression codecs (zlib / int8) + framed blobs
  undo_codec.py undo-log slot format
  nmp.py        near-memory ops (gather / bag-reduce / scatter-add / row
                update / undo snapshot / fused undo-log append / ring scan
                and GC / compressed blob put) + EmbeddingPoolMirror
  faults.py     deterministic crash / torn-write / dropped-flush injection
  metrics.py    traffic + energy counters

Every byte these modules write is the JAX package's, so a pool image made
by either package opens in the other. The wire protocol, the memory-node
server and the sharded pool are not ported.
"""
from repro_torch.pool.allocator import JsonRegion, PoolAllocator, Region
from repro_torch.pool.device import (BACKENDS, DramPool, PmemPool, PoolDevice,
                                     PoolError, TenantIsolationError, make_pool)
from repro_torch.pool.faults import FaultEvent, FaultSchedule, InjectedCrash
from repro_torch.pool.metrics import PoolMetrics
from repro_torch.pool.nmp import EmbeddingPoolMirror, NmpQueue

__all__ = [
    "BACKENDS", "DramPool", "EmbeddingPoolMirror", "FaultEvent",
    "FaultSchedule", "InjectedCrash", "JsonRegion", "NmpQueue", "PmemPool",
    "PoolAllocator", "PoolDevice", "PoolError", "PoolMetrics", "Region",
    "TenantIsolationError", "make_pool",
]
