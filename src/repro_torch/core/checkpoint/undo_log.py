"""Per-step sparse undo logs in the pool's *log region* (paper Fig. 6/7);
counterpart of ``repro.core.checkpoint.undo_log``, with the same layout.

The ring lives in the ``undo-log`` persistence domain of a ``PoolDevice``:

    meta (JsonRegion)   {gen, nslots, slot_bytes}
    ring<gen> (Region)  nslots fixed-size slots

Slot layout (``repro_torch.pool.undo_codec``) for step N (slot = N mod nslots):

    header  step i64 | n i64 | d i64 | flags i64 | stored_len i64
            | payload-crc u32 | commit u32
    payload idx int64[n] | old_rows f32[n,d] | (old_acc f32[n,d])
            possibly compressed pool-side

The writer persists the payload first (``undo-payload`` barrier), then sets
the COMMIT word and persists it separately (``undo-commit``, the paper's
persistent flag). The CRC covers the *stored* bytes, so a torn payload or a
dropped commit flush both invalidate the entry. GC clears COMMIT words once
both tiers are durable.

The hot path is ``log_and_apply``: ONE near-memory op (``undo_log_append``)
captures the pre-update image, logs and commits it, and applies the new
rows, all inside the memory node. ``append`` is the host-driven write of
an image the host holds (the calibration rig's wire mode); both paths
write the same slot bytes.

Ring growth is crash-safe by ordering: the new ring is allocated and every
still-committed entry is carried over FIRST; the meta flip, the only
durable commit point of the grow, happens LAST, and the old ring's COMMIT
words are never touched. Once the flip is durable the outgrown generation
is freed; a generation leaked by a crash in that window is reclaimed by the
open-time sweep, which frees by name and so can never double-free.

The serving tier reads the ring too: ``committed_after`` (its tailer's
poll) and ``read_many`` decode several committed steps in one header scan
and one batched payload read. ``open_ring(device, readonly=True)`` opens
it as a pure reader, which never sweeps, grows or writes. Over a remote
pool (a memory node) the fused append, the committed-set scan and the GC
are one wire round trip each; a read-only tenant's ring reads and never
writes. ``slot_image`` is the sharded pool's commit-coupled replication
unit (``ShardedPool.ship_slot``). A read-only ring refuses ``append``,
``log_and_apply`` and ``gc``.
"""
from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from repro_torch.pool import undo_codec as uc
from repro_torch.pool.allocator import Domain, JsonRegion, PoolAllocator, Region
from repro_torch.pool.device import PoolDevice, TenantIsolationError
from repro_torch.pool.nmp import NmpQueue

_ALIGN = 64

DOMAIN = "undo-log"


class UndoRing:
    def __init__(self, alloc: PoolAllocator, max_logs: int,
                 compress: str = "zlib"):
        self.alloc = alloc
        self.device: PoolDevice = alloc.device
        self.domain: Domain = alloc.domain(DOMAIN)
        self.nslots = max(2, int(max_logs) + 1)
        self.compress = compress
        self.nmp = NmpQueue(self.device)
        self.meta = JsonRegion.create(self.domain, "meta", nbytes=4 << 10)
        m = self.meta.read()
        self.ring: Optional[Region] = None
        # writer-tracked liveness (slot -> step of the entry it holds):
        # None = unknown (attached to a pre-existing ring), rebuilt by the
        # first gc with ONE header scan
        self._live: Optional[dict[int, int]] = None
        if m is not None:
            self.nslots = m["nslots"]
            self.slot_bytes = m["slot_bytes"]
            self.gen = m["gen"]
            self.ring = self.domain.get(f"ring{self.gen}")
        else:
            self.slot_bytes = 0
            self.gen = -1
        # a readonly opener (the serving tier tailing commits) may not free
        # anything: leaked generations are the writer's to reclaim
        if not getattr(alloc, "readonly", False):
            self._sweep_stale_rings()

    # -- layout --------------------------------------------------------------
    def _sweep_stale_rings(self):
        """Reclaim superseded ring generations (gen < live), which a crash
        between meta flip and free leaked. Half-built future generations are
        left in place: the next grow reuses and scrubs them."""
        for name in sorted(self.domain.regions().keys()):
            if not name.startswith("ring"):
                continue
            gen = name[4:]
            if gen.lstrip("-").isdigit() and int(gen) < self.gen:
                self.domain.free_region(name, point="undo-grow-free")

    def _alloc_ring(self, gen: int, need: int) -> tuple[Region, int]:
        """Allocate ring<gen> sized for `need`-byte entries. Does NOT touch
        meta. A ring<gen> left behind by a grow that crashed before its
        meta flip is scrubbed (COMMIT words cleared) before reuse."""
        slot_bytes = -(-int(need * 1.5) // _ALIGN) * _ALIGN
        name = f"ring{gen}"
        stale = self.domain.get(name) is not None
        ring = self.domain.alloc(
            name, shape=(self.nslots * slot_bytes,),
            dtype="uint8", point="undo-grow-alloc" if gen else "superblock")
        if stale:
            self.nmp.slot_clear(ring, list(range(self.nslots)), slot_bytes,
                                point="undo-grow-scrub")
        return ring, slot_bytes

    def _flip_meta(self):
        """The durable commit point for ring creation/growth."""
        self.meta.write({"gen": self.gen, "nslots": self.nslots,
                         "slot_bytes": self.slot_bytes}, point="undo-meta")

    def _make_ring(self, need: int):
        """First ring (nothing to carry over): alloc, then flip."""
        self.gen += 1
        self.ring, self.slot_bytes = self._alloc_ring(self.gen, need)
        self._flip_meta()
        self._live = {}

    def _slot_off(self, step: int) -> int:
        return self.ring.off + (step % self.nslots) * self.slot_bytes

    def _ensure_capacity(self, raw_need: int):
        if self.ring is None:
            self._make_ring(raw_need)
        elif raw_need > self.slot_bytes:
            self._grow(raw_need)

    # -- write path ----------------------------------------------------------
    def _check_writer(self, op: str):
        if getattr(self.alloc, "readonly", False):
            raise TenantIsolationError(f"readonly undo ring: {op} denied")

    def _write_slot(self, step: int, idx: np.ndarray, old_rows: np.ndarray,
                    old_acc: Optional[np.ndarray]):
        """Host-driven slot write through the same two-barrier commit
        (``uc.write_slot``) the near-memory executor uses, so the host and
        fused paths write the same bytes. Persists the bytes written, not
        the whole slot."""
        buf, _, _ = uc.pack_slot(step, idx, old_rows, old_acc,
                                 mode=self.compress,
                                 slot_bytes=self.slot_bytes)
        uc.write_slot(self.device, self._slot_off(step), buf)

    def append(self, step: int, idx: np.ndarray, old_rows: np.ndarray,
               old_acc: Optional[np.ndarray] = None):
        """Log and commit a step's undo image written from the host: the
        rows (and optimizer accumulator rows) at ``idx`` before the update.
        The calibration rig's wire mode logs through it."""
        self._check_writer("append")
        idx = np.asarray(idx).reshape(-1)
        old_rows = np.asarray(old_rows, np.float32).reshape(idx.size, -1)
        self._ensure_capacity(uc.slot_nbytes(idx.size, old_rows.shape[-1],
                                             old_acc is not None))
        self._write_slot(step, idx, old_rows, old_acc)
        self._note_live(step)

    def log_and_apply(self, step: int, mirror: Region, idx: np.ndarray,
                      new_rows: np.ndarray) -> dict:
        """Tier-E hot path: capture + log + COMMIT + apply in one
        near-memory op. Returns the op's {"stored", "raw"} byte counts."""
        self._check_writer("log_and_apply")
        idx = np.asarray(idx).reshape(-1)
        new_rows = np.asarray(new_rows, np.float32).reshape(idx.size, -1)
        self._ensure_capacity(uc.slot_nbytes(idx.size, new_rows.shape[-1],
                                             False))
        stats = self.nmp.undo_log_append(
            mirror, self.ring, step=step, slot_off=self._slot_off(step),
            slot_bytes=self.slot_bytes, idx=idx, new_rows=new_rows,
            compress=self.compress)
        self._note_live(step)
        return stats

    def _read_slot_verbatim(self, step: int) -> Optional[bytes]:
        """CRC-checked copy of a committed slot's stored bytes, COMMIT word
        cleared, ready for ``uc.write_slot`` into another ring (no re-encode,
        so lossy int8 payloads carry over bit-identically)."""
        hdr = self._read_header(step % self.nslots) if self.ring else None
        if hdr is None or hdr[0] != step:
            return None
        _, n, d, flags, stored_len, crc = hdr
        off = self._slot_off(step)
        stored = bytes(self.device.view(off + uc.HDR.size, stored_len))
        if zlib.crc32(stored) != crc:
            return None
        return uc.HDR.pack(step, n, d, flags, stored_len, crc, 0) + stored

    def slot_image(self, step: int) -> Optional[tuple[str, int, bytes]]:
        """The commit-coupled replication unit of a committed step: (ring
        region name, slot offset within the region, verbatim slot bytes),
        ready for ``ShardedPool.ship_slot``, which reruns the two-barrier
        commit at the same offset of the replica's ring. None when the
        step's slot is gone (GC'd, overwritten or torn): the shipper then
        refreshes the whole ring."""
        buf = self._read_slot_verbatim(step)
        if buf is None:
            return None
        return (f"ring{self.gen}", (step % self.nslots) * self.slot_bytes, buf)

    def _grow(self, need: int):
        """Entry outgrew the slot: allocate a bigger ring, carry the
        still-committed entries over verbatim, flip meta, and only then
        free the outgrown generation. Until the flip persists, recovery
        still reads the old ring, so a crash anywhere mid-grow loses
        nothing."""
        entries = [(s, buf) for s in self.committed_steps()
                   if (buf := self._read_slot_verbatim(s)) is not None]
        old_gen = self.gen
        new_gen = self.gen + 1
        new_ring, new_slot_bytes = self._alloc_ring(new_gen, need)
        self.ring, self.gen, self.slot_bytes = (new_ring, new_gen,
                                                new_slot_bytes)
        for step, buf in entries:
            uc.write_slot(self.device, self._slot_off(step), buf)
        self._flip_meta()
        self._live = {step % self.nslots: step for step, _ in entries}
        if old_gen >= 0:
            self.domain.free_region(f"ring{old_gen}",
                                    point="undo-grow-free")

    # -- read path -----------------------------------------------------------
    def _read_header(self, step_slot: int):
        """Single-slot header probe (no payload copy / CRC)."""
        if self.ring is None:
            return None
        off = self.ring.off + step_slot * self.slot_bytes
        raw = bytes(self.device.view(off, uc.HDR.size))
        return uc.parse_header(raw, self.slot_bytes)

    def _scan_headers(self) -> list:
        """All committed slot headers in ONE strided near-memory read.
        Returns [(slot, (step, n, d, flags, stored_len, crc)), ...]."""
        if self.ring is None:
            return []
        hdrs = self.nmp.slot_headers(self.ring, self.nslots,
                                     self.slot_bytes, uc.HDR.size)
        out = []
        for i in range(self.nslots):
            got = uc.parse_header(bytes(hdrs[i]), self.slot_bytes)
            if got is not None:
                out.append((i, got))
        return out

    def read(self, step: int):
        """(idx, old_rows, None) of a committed step, or None when its slot
        is gone or fails its CRC."""
        hdr = self._read_header(step % self.nslots) if self.ring else None
        if hdr is None or hdr[0] != step:
            return None
        _, n, d, flags, stored_len, crc = hdr
        off = self._slot_off(step)
        stored = bytes(self.device.view(off + uc.HDR.size, stored_len))
        if zlib.crc32(stored) != crc:
            return None
        return uc.decode_payload(stored, n, d, flags)

    def _read_payloads(self, hits) -> dict:
        """hits = [(step, slot, hdr), ...] -> {step: payload or None}. ONE
        batched ``read_batch`` moves every stored payload; a CRC miss (the
        slot GC'd or overwritten since the scan) maps to None."""
        reqs = [(self.ring.off + slot * self.slot_bytes + uc.HDR.size,
                 hdr[4]) for _, slot, hdr in hits]
        blobs = self.device.read_batch(reqs, tag="undo-read")
        out = {}
        for (s, _, hdr), stored in zip(hits, blobs, strict=True):
            _, n, d, flags, stored_len, crc = hdr
            stored = bytes(stored)
            out[s] = uc.decode_payload(stored, n, d, flags) \
                if zlib.crc32(stored) == crc else None
        return out

    def read_many(self, steps) -> dict:
        """{step: decoded payload} for several committed steps: ONE header
        scan locates them, ONE batched read moves the payloads. CRC-failed
        entries are dropped, as ``read`` drops them."""
        steps = [int(s) for s in steps]
        if self.ring is None or not steps:
            return {}
        want = set(steps)
        hits = [(hdr[0], slot, hdr) for slot, hdr in self._scan_headers()
                if hdr[0] in want]
        if not hits:
            return {}
        return {s: p for s, p in self._read_payloads(hits).items()
                if p is not None}

    def committed_after(self, watermark: int) -> dict:
        """{step: payload or None} for every committed step > watermark, in
        one header scan and one batched read: the serving tier's tailer
        poll. None marks a step whose slot was GC'd or overwritten between
        the scan and the read (the caller still sees the step and can
        advance its watermark)."""
        if self.ring is None:
            return {}
        hits = [(hdr[0], slot, hdr) for slot, hdr in self._scan_headers()
                if hdr[0] > watermark]
        if not hits:
            return {}
        return self._read_payloads(hits)

    def committed_steps(self) -> list[int]:
        return sorted(hdr[0] for _, hdr in self._scan_headers())

    def _note_live(self, step: int):
        if self._live is not None:
            self._live[step % self.nslots] = step

    def gc(self, keep_from: int):
        """Invalidate committed entries older than keep_from (both tiers
        durable, paper step 4) in one batched ``slot_clear``. Only the first
        gc after attaching to a pre-existing ring pays a header scan."""
        self._check_writer("gc")
        if self.ring is None:
            return
        if self._live is None:
            self._live = {slot: hdr[0]
                          for slot, hdr in self._scan_headers()}
        expired = sorted(slot for slot, step in self._live.items()
                         if step < keep_from)
        if expired:
            self.nmp.slot_clear(self.ring, expired, self.slot_bytes,
                                point="undo-gc")
            for slot in expired:
                del self._live[slot]


def open_ring(device: PoolDevice, max_logs: int = 64,
              readonly: bool = False) -> UndoRing:
    """Attach to an existing undo domain. With ``readonly`` the ring is a
    pure reader (the serving tier's commit tailer): it never sweeps, grows
    or writes."""
    return UndoRing(PoolAllocator(device, readonly=readonly), max_logs)
