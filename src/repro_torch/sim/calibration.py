"""Measured pool batches for the simulator's calibration and the energy rows
(counterpart of ``repro.sim.calibration``: the same batch protocol, the same
seed and sizes, so every byte counter equals the JAX package's).

One RM1-shaped training batch replayed against a fresh emulated pool device
of the port: a near-memory bag lookup, then the undo capture of its touched
rows in one of two modes:

  * ``wire``: the undo image goes out to the host (``undo_snapshot``) and
    comes back through the host-driven ring write (``UndoRing.append``),
    uncompressed; the write-back leg is charged to the link (``link_in``);
  * ``pool``: the paper's design, one fused ``log_and_apply`` that captures,
    compresses (zlib) and commits the image inside the memory node, so only
    (idx, new rows) cross the link.

The one-time mirror load and the ring's warm-up are left out of the
counters. The returned ``PoolMetrics`` feeds ``engine.calibrate_from_pool``
and ``PoolMetrics.energy``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def embedding_like_table(rng, shape) -> np.ndarray:
    """Embedding-like (not max-entropy) values: quantised mantissas, the
    compressible structure trained tables have."""
    return (rng.integers(-512, 512, shape) / 256.0).astype(np.float32)


def measured_pool_batch(backend: str = "pmem", mode: str = "pool", *,
                        dim: int = 32, n_tables: int = 20,
                        rows_per: int = 2048, batch: int = 256,
                        n_sparse: int = 8, path: Optional[str] = None,
                        with_blob: bool = False):
    """Run one measured batch (the near-memory bag lookup and the tier-E
    capture in ``mode``, and a dense ``blob_put`` with ``with_blob``) on a
    fresh ``backend`` device ("dram", or "pmem" at ``path``) and return its
    ``PoolMetrics``."""
    from repro_torch.core.checkpoint.undo_log import UndoRing
    from repro_torch.pool import (DramPool, EmbeddingPoolMirror, NmpQueue,
                                  PmemPool, PoolAllocator)

    capacity = n_tables * rows_per * dim * 8
    if backend == "dram":
        dev = DramPool(capacity=capacity)
    else:
        if not path:
            raise ValueError("pmem measurement needs a file path")
        dev = PmemPool(path, capacity=capacity)
    rng = np.random.default_rng(0)
    table = embedding_like_table(rng, (n_tables, rows_per, dim))
    mir = EmbeddingPoolMirror(dev, table)
    alloc = PoolAllocator(dev)
    ring = UndoRing(alloc, max_logs=4,
                    compress="none" if mode == "wire" else "zlib")
    dense = alloc.domain("dense").alloc("slot0", shape=(1 << 16,),
                                        dtype="uint8") if with_blob else None
    ids = rng.integers(0, rows_per, (batch, n_tables, n_sparse))
    flat_idx = np.unique(ids + np.arange(n_tables)[None, :, None]
                         * rows_per)
    flat = table.reshape(-1, dim)
    new_rows = (flat[flat_idx] * 0.999).astype(np.float32)
    # the warm-up sizes the ring, so its growth stays out of the counters
    ring.append(0, flat_idx, flat[flat_idx])
    dev.metrics.reset()          # count the batch, not the warm-up or load

    reduced = mir.bag_lookup(ids)                  # near-memory reduce
    if mode == "wire":
        # the image out over the link and logged from the host; the device's
        # write meters the media only, so the write-back leg (idx and old
        # rows crossing back in) is charged to the link here
        old = mir.nmp.undo_snapshot(mir.region, flat_idx)
        ring.append(1, flat_idx, old)
        dev.metrics.record_link("link_in", flat_idx.nbytes + old.nbytes)
        mir.nmp.row_update(mir.region, flat_idx, new_rows,
                           point="mirror-apply")
    else:
        ring.log_and_apply(1, mir.region, flat_idx, new_rows)
    if dense is not None:
        NmpQueue(dev).blob_put(dense, np.zeros(1 << 14, np.uint8).tobytes())
    assert reduced.shape == (batch, n_tables, dim)
    m = dev.metrics
    dev.close()
    return m
