"""Near-memory ops, the CXL-MEM *computing logic* (counterpart of
``repro.pool.nmp``).

Ops execute against region cache views inside the pool device, so only the
operands (indices, gradients, new rows) and the *results* (gathered rows or
bag-reduced vectors) cross the host link; undo images never do. Each op
charges the device's ``PoolMetrics`` as the JAX package's does: media
traffic at Table-2 random-access latency/bandwidth, the near-memory adder
array's busy time for reductions, and link traffic for whatever enters or
leaves the pool.

The ops: the lookups serving runs (``gather``, ``bag_gather``), the
near-memory update (``scatter_add``), the round-trip undo capture
(``undo_snapshot``), and the ones checkpointing and recovery run (the fused
undo-log append, the row update of a rollback, the undo-ring header scan
and GC, the compressed blob write of a dense snapshot), and the verbatim
region export and import that move a region between nodes.
``EmbeddingPoolMirror`` is a table in the pool behind the ``pool`` lookup
strategy of ``core.embedding_ops``.

Against a ``RemotePool`` every op is shipped as one ``nmp`` wire frame and
runs inside the memory-node process (``repro_torch.pool.server``), where
near-memory compute belongs: only operands and results cross the link. The
op surface (kinds, wire fields, mutability, timeout classes) is described
once, in ``protocol.NMP_OPS``, which the server dispatches through.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.pool import compress as pc
from repro_torch.pool import undo_codec as uc
from repro_torch.pool.allocator import Region
from repro_torch.pool.device import PoolDevice, PoolError
from repro_torch.pool.faults import InjectedCrash


class NmpQueue:
    """Near-memory op dispatch. Against a local device the ops run
    in-process on zero-copy cache views; against a ``RemotePool`` each op
    is one ``nmp`` wire frame, executed inside the memory node."""

    def __init__(self, device: PoolDevice):
        self.device = device
        self._remote = getattr(device, "remote", False)
        self._pending: list = []

    # -- queue machinery -----------------------------------------------------
    def submit(self, fn, *args, **kw):
        self._pending.append((fn, args, kw))

    def drain(self) -> list:
        out = [fn(*args, **kw) for fn, args, kw in self._pending]
        self._pending = []
        return out

    def batch(self, calls) -> list:
        """[(kind, region, kwargs), ...] through the protocol's op registry:
        ONE scatter-gather wire frame on a remote device (wire v2 and up),
        an in-order local run otherwise."""
        return self.device.nmp_batch(calls)

    # -- helpers -------------------------------------------------------------
    def _rows_meta(self, region: Region):
        view = region.view_array()
        flat = view.reshape(-1, view.shape[-1])
        row_bytes = flat.shape[-1] * flat.dtype.itemsize
        return flat, row_bytes

    def _mark_rows_dirty(self, region: Region, idx: np.ndarray,
                         row_bytes: int):
        idx = np.unique(idx)                 # sorted unique rows
        if idx.size == 0:
            return
        # coalesce consecutive rows into ranges (vectorized: per-row marks
        # are far too slow for DLRM-sized touch sets)
        breaks = np.nonzero(np.diff(idx) > 1)[0]
        starts = idx[np.concatenate(([0], breaks + 1))].tolist()
        ends = idx[np.concatenate((breaks, [idx.size - 1]))].tolist()
        for s, e in zip(starts, ends, strict=True):
            region.mark_dirty(int(s) * row_bytes,
                              int(e - s + 1) * row_bytes)

    # -- ops -----------------------------------------------------------------
    def gather(self, region: Region, idx) -> np.ndarray:
        """rows[idx] -> host. The link carries idx in and the raw rows out."""
        idx = np.asarray(idx)
        if self._remote:
            return self.device.nmp("gather", region, idx=idx)
        flat, row_bytes = self._rows_meta(region)
        out = flat[idx.reshape(-1)].reshape(*idx.shape, flat.shape[-1]).copy()
        m = self.device.metrics
        m.record("gather", idx.size * row_bytes,
                 self.device.profile.t_random_read(idx.size, row_bytes))
        m.record_link("link_in", idx.nbytes)
        m.record_link("link_out", out.nbytes)
        return out

    def bag_gather(self, region: Region, idx, combine: str = "sum") -> np.ndarray:
        """Reduce rows[idx] over the last idx axis pool-side; only the
        reduced (..., d) vectors cross the link. On a stacked (T, R, d)
        region, idx is (..., T, L) with each table's own row ids, and each
        table's row offset t * R is added to them first.

        Over the wire the ids are flat: this client adds the offsets and
        names the region by its flat (T * R, d) view, so a node of either
        package reduces the same rows (the JAX package's server adds no
        offsets, the port's adds none to a flat region)."""
        idx = np.asarray(idx)
        if len(region.shape) == 3:
            T, R, d = region.shape
            if idx.ndim < 2 or idx.shape[-2] != T:
                raise ValueError(f"bag ids {idx.shape} do not index the "
                                 f"{T} stacked tables of {region.shape}")
            idx = idx + (np.arange(T)[:, None] * R).astype(idx.dtype)
            region = Region(region.device, region.domain, region.name,
                            region.off, region.nbytes, region.dtype,
                            (T * R, d))
        if self._remote:
            return self.device.nmp("bag_gather", region, idx=idx,
                                   combine=combine)
        flat, row_bytes = self._rows_meta(region)
        rows = flat[idx.reshape(-1)].reshape(*idx.shape, flat.shape[-1])
        red = rows.sum(axis=-2) if combine == "sum" else rows.mean(axis=-2)
        red = np.ascontiguousarray(red)
        m = self.device.metrics
        m.record("bag_gather", idx.size * row_bytes,
                 self.device.profile.t_random_read(idx.size, row_bytes))
        m.record_ndp(idx.size * flat.shape[-1])          # adder array
        m.record_link("link_in", idx.nbytes)
        m.record_link("link_out", red.nbytes)
        return red

    def row_update(self, region: Region, idx, rows,
                   point: Optional[str] = None):
        """rows -> pool at idx (the embedding apply). Idempotent writes."""
        idx = np.asarray(idx).reshape(-1)
        rows = np.asarray(rows)
        if self._remote:
            self.device.nmp("row_update", region, idx=idx, rows=rows,
                            point=point)
            return
        flat, row_bytes = self._rows_meta(region)
        flat[idx] = rows.reshape(idx.size, -1)
        self._mark_rows_dirty(region, idx, row_bytes)
        m = self.device.metrics
        m.record("row_update", idx.size * row_bytes,
                 self.device.profile.t_random_write(idx.size, row_bytes))
        m.record_link("link_in", idx.nbytes + rows.nbytes)
        if point is not None:
            region.persist(point=point)

    def scatter_add(self, region: Region, idx, delta,
                    point: Optional[str] = None):
        """Accumulate gradient rows pool-side (read-modify-write)."""
        idx = np.asarray(idx).reshape(-1)
        delta = np.asarray(delta)
        if self._remote:
            self.device.nmp("scatter_add", region, idx=idx, rows=delta,
                            point=point)
            return
        flat, row_bytes = self._rows_meta(region)
        np.add.at(flat, idx, delta.reshape(idx.size, -1).astype(flat.dtype))
        self._mark_rows_dirty(region, idx, row_bytes)
        m = self.device.metrics
        t = (self.device.profile.t_random_read(idx.size, row_bytes)
             + self.device.profile.t_random_write(idx.size, row_bytes))
        m.record("scatter_add", 2 * idx.size * row_bytes, t)
        m.record_ndp(idx.size * flat.shape[-1])
        m.record_link("link_in", idx.nbytes + delta.nbytes)
        if point is not None:
            region.persist(point=point)

    def undo_snapshot(self, region: Region, idx) -> np.ndarray:
        """The pre-update image of rows[idx], returned to the host: the
        round-trip capture, whose old rows cross the link out. The paper's
        design is ``undo_log_append``, which never ships the image."""
        idx = np.asarray(idx).reshape(-1)
        if self._remote:
            return self.device.nmp("undo_snapshot", region, idx=idx)
        flat, row_bytes = self._rows_meta(region)
        old = np.array(flat[idx])
        m = self.device.metrics
        m.record("undo_snapshot", idx.size * row_bytes,
                 self.device.profile.t_random_read(idx.size, row_bytes))
        m.record_link("link_in", idx.nbytes)
        m.record_link("link_out", old.nbytes)
        return old

    def undo_log_append(self, mirror: Region, log: Region, *, step: int,
                        slot_off: int, slot_bytes: int, idx,
                        new_rows: Optional[np.ndarray] = None,
                        compress: str = "zlib",
                        apply_point: str = "mirror-apply") -> dict:
        """Undo capture inside the pool (paper Fig. 6/7).

        Snapshot mirror[idx], compress + write the undo entry into the log
        slot, persist payload and COMMIT flag with the two paper barriers,
        then (fused) apply ``new_rows`` to the mirror. Only ``(step, idx,
        new_rows)`` cross the link; the old row images never leave the
        pool. Returns {"stored", "raw"} byte counts of the logged payload.
        On a remote device the op is one frame carrying (step, idx,
        new_rows) and the slot's place; the node does the rest."""
        idx = np.asarray(idx).reshape(-1)
        if self._remote:
            return self.device.nmp(
                "undo_log_append", mirror, idx=idx, rows=new_rows,
                point=apply_point, log_region=log, step=int(step),
                slot_off=int(slot_off), slot_bytes=int(slot_bytes),
                compress=compress)
        if not (log.off <= slot_off
                and slot_off + slot_bytes <= log.off + log.nbytes):
            raise PoolError(f"undo slot [{slot_off}, {slot_off + slot_bytes})"
                            f" outside log region")
        dev = self.device
        m = dev.metrics
        # operands in; results never out
        m.record_link("link_in", idx.nbytes + uc.HDR.size
                      + (0 if new_rows is None else
                         np.asarray(new_rows).nbytes))
        # 1: batch-aware capture of the pre-update image (media-only read)
        flat, row_bytes = self._rows_meta(mirror)
        old = np.array(flat[idx])
        m.record("undo_snapshot", idx.size * row_bytes,
                 dev.profile.t_random_read(idx.size, row_bytes))
        # 2: compress + log entry (payload barrier), then COMMIT (its own)
        buf, stored_len, raw_len = uc.pack_slot(step, idx, old, None,
                                                mode=compress,
                                                slot_bytes=slot_bytes)
        if compress != "none":     # engine idle when compression is off
            m.record_comp(raw_len, stored_len, raw_len / pc.COMPRESS_BPS,
                          kind="undo")
        uc.write_slot(dev, slot_off, buf)
        stats = {"stored": stored_len, "raw": raw_len}
        if new_rows is None:
            return stats
        # 3 (fused): idempotent in-place apply. The commit/apply boundary is
        # a named fault point inside the node, so crash drills land exactly
        # between the two barriers.
        f = dev.faults
        if f is not None and \
                f.hit("tier_e.between-commit-and-apply") == "crash-after":
            raise InjectedCrash("tier_e.between-commit-and-apply",
                                f.counts["tier_e.between-commit-and-apply"])
        new_rows = np.asarray(new_rows, flat.dtype).reshape(idx.size, -1)
        flat[idx] = new_rows
        self._mark_rows_dirty(mirror, idx, row_bytes)
        m.record("row_update", idx.size * row_bytes,
                 dev.profile.t_random_write(idx.size, row_bytes))
        mirror.persist(point=apply_point)
        return stats

    def slot_headers(self, log: Region, nslots: int, slot_bytes: int,
                     hdr_bytes: int) -> np.ndarray:
        """Strided gather of every slot header in one op (one round trip on
        a remote device)."""
        if self._remote:
            return self.device.nmp("slot_headers", log, nslots=int(nslots),
                                   slot_bytes=int(slot_bytes),
                                   hdr_bytes=int(hdr_bytes))
        v = self.device.view(log.off, nslots * slot_bytes)
        out = np.lib.stride_tricks.as_strided(
            v, (nslots, hdr_bytes), (slot_bytes, 1)).copy()
        m = self.device.metrics
        m.record("undo_scan", nslots * hdr_bytes,
                 self.device.profile.t_random_read(nslots, hdr_bytes))
        m.record_link("link_in", 16)
        m.record_link("link_out", out.nbytes)
        return out

    def slot_clear(self, log: Region, slots, slot_bytes: int,
                   point: str = "undo-gc") -> int:
        """Clear the COMMIT words of many expired slots in ONE op, under one
        clipped barrier."""
        slots = np.asarray(slots, np.int64).reshape(-1)
        if self._remote:
            return int(self.device.nmp(
                "slot_clear", log, slots=[int(s) for s in slots],
                slot_bytes=int(slot_bytes), point=point)["cleared"])
        if slots.size == 0:
            return 0
        for s in slots:
            off = log.off + int(s) * slot_bytes
            self.device.write(off + uc.COMMIT_OFF, uc.COMMIT_CLEAR,
                              tag="undo")
        lo = int(slots.min()) * slot_bytes
        hi = (int(slots.max()) + 1) * slot_bytes
        self.device.persist(log.off + lo, hi - lo, point=point)
        self.device.metrics.record_link("link_in", 16 + slots.nbytes)
        return int(slots.size)

    def blob_put(self, region: Region, blob, *, compress: str = "zlib",
                 point: str = "dense-blob") -> int:
        """Write an opaque blob through the pool's compression engine: the
        raw bytes cross the link in, the *framed, compressed* image hits
        media, and exactly the written range is persisted. Returns the
        stored (framed) length, what a reader must fetch and ``unframe``."""
        if self._remote:
            return self.device.nmp("blob_put", region, blob=blob,
                                   point=point, compress=compress)["stored"]
        blob = blob if isinstance(blob, (bytes, bytearray, memoryview)) \
            else memoryview(np.ascontiguousarray(blob)).cast("B")
        framed = pc.frame(blob, mode=compress)
        if len(framed) > region.nbytes:
            raise PoolError(f"blob ({len(framed)}B framed) overflows region "
                            f"{region.domain}/{region.name} "
                            f"({region.nbytes}B)")
        m = self.device.metrics
        m.record_link("link_in", len(blob))
        if compress != "none":     # engine idle when compression is off
            # frame header excluded: the ratio compares payload bytes only
            m.record_comp(len(blob), len(framed) - pc.FRAME_OVERHEAD,
                          len(blob) / pc.COMPRESS_BPS, kind="blob")
        self.device.write(region.off, framed, tag="dense")
        self.device.persist(region.off, len(framed), point=point)
        return len(framed)

    def region_export(self, region: Region, compress: str = "zlib") -> bytes:
        """Verbatim region image -> one framed, pool-compressed blob (CRC
        over the stored bytes), the read half of a region's move between
        nodes: the node compresses before the image leaves it."""
        if self._remote:
            out = self.device.nmp("region_export", region, compress=compress)
            return bytes(np.ascontiguousarray(out).view(np.uint8))
        raw = bytes(self.device.read(region.off, region.nbytes,
                                     tag="migrate_export"))
        framed = pc.frame(raw, mode=compress)
        m = self.device.metrics
        if compress != "none":     # engine idle when compression is off
            m.record_comp(len(raw), len(framed) - pc.FRAME_OVERHEAD,
                          len(raw) / pc.COMPRESS_BPS, kind="migrate")
        m.record_link("link_in", 16)
        m.record_link("link_out", len(framed))
        return framed

    def region_import(self, region: Region, frame,
                      point: str = "migrate-import"):
        """Inverse of ``region_export``: CRC-check and unframe inside the
        node, land the raw image verbatim in the region, persist exactly
        that range. The copy is bit-identical to the exported image."""
        if not isinstance(frame, (bytes, bytearray, memoryview)):
            frame = memoryview(np.ascontiguousarray(frame)).cast("B")
        if self._remote:
            self.device.nmp("region_import", region, blob=frame, point=point)
            return
        raw = pc.unframe(frame)                 # BlobCorruptError on a tear
        if len(raw) != region.nbytes:
            raise PoolError(f"region_import {region.domain}/{region.name}: "
                            f"image {len(raw)}B != region {region.nbytes}B")
        m = self.device.metrics
        m.record_link("link_in", len(frame))
        if len(frame) - pc.FRAME_OVERHEAD < len(raw):   # it was compressed
            m.record_comp(len(raw), len(frame) - pc.FRAME_OVERHEAD,
                          len(raw) / pc.COMPRESS_BPS, kind="migrate")
        self.device.write(region.off, raw, tag="migrate_import")
        self.device.persist(region.off, region.nbytes, point=point)


class EmbeddingPoolMirror:
    """Host-visible handle to an embedding table living in a pool domain:
    the substrate behind ``core.embedding_ops``' ``pool`` lookup strategy.

    ``table`` may be (V, d) or stacked DLRM (T, R, d), held in f32; bag
    lookups on the stacked form add per-table row offsets pool-side
    (``NmpQueue.bag_gather``).
    """

    DOMAIN = "embedding-ops"

    def __init__(self, device: PoolDevice, table: np.ndarray,
                 name: str = "table"):
        from repro_torch.pool.allocator import PoolAllocator
        self.device = device
        self.alloc = PoolAllocator(device)
        table = np.asarray(table, dtype=np.float32)
        self.region = self.alloc.domain(self.DOMAIN).alloc(
            name, shape=table.shape, dtype="float32")
        self.region.write_array(table, tag="mirror-load")
        self.region.persist(point="mirror-load")
        self.nmp = NmpQueue(device)

    @property
    def shape(self):
        return self.region.shape

    @property
    def metrics(self):
        return self.device.metrics

    def sync_from(self, table: np.ndarray):
        self.region.write_array(np.asarray(table, np.float32),
                                tag="mirror-load")
        self.region.persist(point="mirror-load")

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        return self.nmp.gather(self.region, np.asarray(ids))

    def bag_lookup(self, ids: np.ndarray, combine: str = "sum") -> np.ndarray:
        return self.nmp.bag_gather(self.region, np.asarray(ids), combine)

    def apply_grad(self, idx: np.ndarray, grad_rows: np.ndarray,
                   lr: float = 1.0):
        """Near-memory SGD update: rows[idx] -= lr * grad."""
        self.nmp.scatter_add(self.region, idx,
                             -lr * np.asarray(grad_rows, np.float32),
                             point="mirror-apply")
