"""Runtime crash-consistency checker for the pool stack (counterpart of
``repro.analysis.checker``; the same rules over the port's devices).

``CheckedPool`` wraps any ``PoolDevice`` backend (dram, pmem, remote,
sharded) and shadow-tracks every ``write``/``write_async``/``persist``/
``crash``/nmp op per byte range, raising a typed :class:`OrderingViolation`
the moment the persistence discipline is broken — *before* the bug gets a
chance to hide behind a crash window the test matrix doesn't drill:

  * **Rule U** (:class:`UnpersistedReadError`) — bytes read back after a
    ``crash()`` that no ``persist`` call ever covered. The checker validates
    the *software* ordering discipline: a persist call covers its range even
    when the fault schedule drops/tears it (surviving injected media faults
    is the recovery tests' job, not the caller's).
  * **Rule C** (:class:`CommitBeforePayloadError`) — a COMMIT-role barrier
    (``undo-commit``) persisted while payload bytes in the enclosing region
    are still dirty: the paper's two-barrier protocol ran in the wrong
    order.
  * **Rule P** (:class:`WriteAfterPublishError`) — a write landing inside an
    A/B slot after its publish/epoch-flip barrier sealed it and before the
    sibling slot was published over it (single-publish discipline).
  * **Rule F** (:class:`UseAfterFreeError` / :class:`DoubleFreeError` /
    :class:`RegionOverlapError`) — region lifecycle: touching freed bytes,
    freeing twice, allocating two live regions over the same bytes.

Enable with ``make_pool(..., check=True)`` or ``REPRO_POOL_CHECK=1`` —
strictly off the default path otherwise. The wrapper is *not* a
``PoolDevice`` subclass: it forwards everything it does not track via
``__getattr__`` so backend-specific surface (proxy allocator, migration,
metrics, wire stats) keeps working unchanged.

``ShadowTracker`` is usable standalone (its ``note_*`` event API) so
known-bad sequences can be driven directly in tests without a device.

A region image that moves between nodes in pieces (``sharded.region_pieces``)
reaches ``nmp`` as one ``region_import`` a piece, each a Region over its own
bytes, so the shadow records each piece's span as it lands. The module
imports numpy and the standard library only: the memory node, which loads
no torch, takes ``RecycledBufferError`` from here.
"""
from __future__ import annotations

import bisect
import json
import os
from typing import Optional

import numpy as np

__all__ = [
    "OrderingViolation", "UnpersistedReadError", "CommitBeforePayloadError",
    "WriteAfterPublishError", "UseAfterFreeError", "DoubleFreeError",
    "RegionOverlapError", "RecycledBufferError", "ShadowTracker",
    "CheckedPool", "checking_enabled",
]


def checking_enabled() -> bool:
    """True when ``REPRO_POOL_CHECK`` asks for the checker (CI cell / soak
    nightly / local debugging); ``make_pool(..., check=None)`` consults
    this."""
    return os.environ.get("REPRO_POOL_CHECK", "").strip().lower() \
        in {"1", "true", "yes", "on"}


# ---------------------------------------------------------------------------
# typed violations
# ---------------------------------------------------------------------------
class OrderingViolation(Exception):
    """Base of every checker diagnosis. Deliberately NOT a ``PoolError``:
    failover paths catch ``PoolError`` to mean "node dead" and must never
    swallow an ordering diagnosis."""


class UnpersistedReadError(OrderingViolation):
    """Rule U: bytes read back after a crash were never covered by any
    ``persist`` call — the caller is trusting volatile cache contents."""


class CommitBeforePayloadError(OrderingViolation):
    """Rule C: a COMMIT barrier persisted while its payload was still
    dirty — the paper's barrier order (payload first, flag second) was
    inverted or the payload persist was skipped."""


class WriteAfterPublishError(OrderingViolation):
    """Rule P: a write landed inside an A/B slot that a publish barrier
    sealed and that no sibling publish has superseded — in-place mutation
    of the recovery-elected image."""


class UseAfterFreeError(OrderingViolation):
    """Rule F: a read/write/persist/nmp touched bytes of a freed region."""


class DoubleFreeError(OrderingViolation):
    """Rule F: a region freed twice."""


class RegionOverlapError(OrderingViolation):
    """Rule F: an allocation landed over the bytes of a different live
    region."""


class RecycledBufferError(OrderingViolation):
    """Rule L (loaned-buffer lifetime): a wire-v3 recv-buffer memoryview
    was used after its channel recycled the buffer for a later frame —
    the bytes under the view belong to someone else now. Raised by
    ``protocol.Loan.view()`` on a stale generation; the fix is to copy
    the data out before releasing, or ``detach()`` the loan."""


# ---------------------------------------------------------------------------
# interval set
# ---------------------------------------------------------------------------
class _Ranges:
    """Sorted, disjoint half-open byte intervals with bisect-based ops."""

    __slots__ = ("_iv",)

    def __init__(self, iv: Optional[list] = None):
        self._iv: list[tuple[int, int]] = list(iv) if iv else []

    def __bool__(self) -> bool:
        return bool(self._iv)

    def __iter__(self):
        return iter(self._iv)

    def __repr__(self) -> str:
        return f"_Ranges({self._iv!r})"

    def clear(self):
        self._iv = []

    def add(self, s: int, e: int):
        if s >= e:
            return
        iv = self._iv
        i = bisect.bisect_left(iv, (s, -1))
        if i > 0 and iv[i - 1][1] >= s:
            i -= 1
            s = iv[i][0]
            e = max(e, iv[i][1])
        j = i
        while j < len(iv) and iv[j][0] <= e:
            e = max(e, iv[j][1])
            j += 1
        iv[i:j] = [(s, e)]

    def sub(self, s: int, e: int):
        if s >= e or not self._iv:
            return
        iv = self._iv
        i = bisect.bisect_left(iv, (s, -1))
        if i > 0 and iv[i - 1][1] > s:
            i -= 1
        j = i
        repl = []
        while j < len(iv) and iv[j][0] < e:
            a, b = iv[j]
            if a < s:
                repl.append((a, s))
            if b > e:
                repl.append((e, b))
            j += 1
        iv[i:j] = repl

    def overlap(self, s: int, e: int) -> list[tuple[int, int]]:
        out = []
        iv = self._iv
        if s >= e or not iv:
            return out
        i = bisect.bisect_left(iv, (s, -1))
        if i > 0 and iv[i - 1][1] > s:
            i -= 1
        while i < len(iv) and iv[i][0] < e:
            a, b = iv[i]
            out.append((max(a, s), min(b, e)))
            i += 1
        return out

    def covers(self, s: int, e: int) -> bool:
        if s >= e:
            return True
        ov = self.overlap(s, e)
        return len(ov) == 1 and ov[0] == (s, e)


def _fmt(ranges) -> str:
    return ", ".join(f"[{s:#x}, {e:#x})" for s, e in ranges)


# ---------------------------------------------------------------------------
# shadow state
# ---------------------------------------------------------------------------
class ShadowTracker:
    """Per-device shadow of the persistence state machine.

    Event API (all offsets are device-absolute; for a sharded pool that
    means global ``SHARD_SPAN`` offsets):

      * ``note_write(off, nbytes)``   — rules P + F, marks dirty
      * ``note_read(off, nbytes)``    — rules U + F
      * ``note_persist(lo, hi, point)`` — covers dirty/lost; rules C + P
      * ``note_crash(window=None)``   — dirty bytes become *lost*
      * ``note_alloc(key, off, nbytes)`` / ``note_free(key, off, nbytes)``
        — region lifecycle for rule F and rule C's enclosing-region lookup
    """

    def __init__(self, name: str = "pool"):
        self.name = name
        self.dirty = _Ranges()    # written, not yet covered by a persist call
        self.lost = _Ranges()     # dirty at crash time, never persist-covered
        self.freed = _Ranges()    # bytes of freed regions
        self.sealed: list[tuple[int, int]] = []   # published A/B slots
        self.live: dict = {}      # region key -> (off, nbytes)
        self.events = {"write": 0, "read": 0, "persist": 0, "crash": 0,
                       "alloc": 0, "free": 0}

    # -- helpers ---------------------------------------------------------------
    def _check_freed(self, lo: int, hi: int, what: str):
        hit = self.freed.overlap(lo, hi)
        if hit:
            raise UseAfterFreeError(
                f"{self.name}: {what} touches freed bytes {_fmt(hit)} "
                f"(op range [{lo:#x}, {hi:#x}))")

    def _enclosing(self, lo: int, hi: int):
        for key, (off, nbytes) in self.live.items():
            if off <= lo and hi <= off + nbytes:
                return key, off, nbytes
        return None

    # -- events ----------------------------------------------------------------
    def note_write(self, off: int, nbytes: int, what: str = "write"):
        if nbytes <= 0:
            return
        lo, hi = int(off), int(off) + int(nbytes)
        self.events["write"] += 1
        self._check_freed(lo, hi, what)
        for s, e in self.sealed:
            if s < hi and lo < e:
                raise WriteAfterPublishError(
                    f"{self.name}: {what} [{lo:#x}, {hi:#x}) lands inside "
                    f"published slot [{s:#x}, {e:#x}) — the slot was sealed "
                    f"by a publish barrier and no sibling publish has "
                    f"superseded it (single-publish violation)")
        self.lost.sub(lo, hi)
        self.dirty.add(lo, hi)

    def note_read(self, off: int, nbytes: int, what: str = "read"):
        if nbytes <= 0:
            return
        lo, hi = int(off), int(off) + int(nbytes)
        self.events["read"] += 1
        self._check_freed(lo, hi, what)
        hit = self.lost.overlap(lo, hi)
        if hit:
            raise UnpersistedReadError(
                f"{self.name}: {what} [{lo:#x}, {hi:#x}) reads bytes "
                f"{_fmt(hit)} that were written before a crash but never "
                f"covered by any persist call — volatile data trusted as "
                f"durable")

    def note_persist(self, lo: int, hi: int, point: str = "persist",
                     role=None):
        from repro_torch.analysis.points import POINT_ROLES, Role
        lo, hi = int(lo), int(hi)
        self.events["persist"] += 1
        if role is None:
            role = POINT_ROLES.get(point, Role.GENERIC)
        self._check_freed(lo, hi, f"persist[{point}]")
        if role is Role.COMMIT:
            enc = self._enclosing(lo, hi)
            if enc is not None:
                key, off, nbytes = enc
                stray = [seg for seg in self.dirty.overlap(off, off + nbytes)
                         if not (lo <= seg[0] and seg[1] <= hi)]
                if stray:
                    raise CommitBeforePayloadError(
                        f"{self.name}: COMMIT barrier '{point}' over "
                        f"[{lo:#x}, {hi:#x}) persisted while payload bytes "
                        f"{_fmt(stray)} in region {key!r} are still dirty — "
                        f"payload persist skipped or barrier order inverted")
        # a persist call covers its range even if the fault schedule
        # drops/tears it: rule U polices *software* ordering, the recovery
        # tests police media faults
        self.dirty.sub(lo, hi)
        self.lost.sub(lo, hi)
        if role is Role.PUBLISH:
            span = hi - lo
            # the sibling A/B slot (adjacent, equal size) is now stale and
            # writable again
            self.sealed = [(s, e) for s, e in self.sealed
                           if not (e - s == span and (e == lo or s == hi))]
            if (lo, hi) not in self.sealed:
                self.sealed.append((lo, hi))

    def note_crash(self, window: Optional[tuple[int, int]] = None):
        self.events["crash"] += 1
        if window is None:
            for s, e in list(self.dirty):
                self.lost.add(s, e)
            self.dirty.clear()
            # publish state is per-power-cycle: recovery re-elects
            self.sealed = []
            return
        wlo, whi = window
        for s, e in self.dirty.overlap(wlo, whi):
            self.lost.add(s, e)
        self.dirty.sub(wlo, whi)
        self.sealed = [(s, e) for s, e in self.sealed
                       if not (s < whi and wlo < e)]

    def note_alloc(self, key, off: int, nbytes: int, strict: bool = True):
        off, nbytes = int(off), int(nbytes)
        self.events["alloc"] += 1
        if strict:
            for other, (o, n) in self.live.items():
                if other != key and o < off + nbytes and off < o + n:
                    raise RegionOverlapError(
                        f"{self.name}: region {key!r} allocated at "
                        f"[{off:#x}, {off + nbytes:#x}) overlaps live "
                        f"region {other!r} at [{o:#x}, {o + n:#x})")
        self.freed.sub(off, off + nbytes)
        self.lost.sub(off, off + nbytes)
        self.sealed = [(s, e) for s, e in self.sealed
                       if not (s < off + nbytes and off < e)]
        self.live[key] = (off, nbytes)

    def note_free(self, key, off: int, nbytes: int, strict: bool = True):
        off, nbytes = int(off), int(nbytes)
        self.events["free"] += 1
        if strict and nbytes > 0 and key not in self.live \
                and self.freed.covers(off, off + nbytes):
            raise DoubleFreeError(
                f"{self.name}: region {key!r} at "
                f"[{off:#x}, {off + nbytes:#x}) freed twice")
        self.live.pop(key, None)
        self.freed.add(off, off + nbytes)
        self.sealed = [(s, e) for s, e in self.sealed
                       if not (s < off + nbytes and off < e)]


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
_FORWARD_SET = frozenset({"faults", "epoch_sink", "placement", "rebalance",
                          "migrate_window_hook", "closed"})

# nmp kinds by shadow effect (kept in sync with protocol.NMP_OPS — the
# linter's registry rule flags drift)
_NMP_READS = {"gather", "bag_gather", "undo_snapshot", "slot_headers",
              "region_export"}
_NMP_WRITES = {"row_update", "scatter_add", "region_import", "blob_put",
               "slot_clear"}


def _buf_len(data) -> int:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return len(data)
    return int(np.ascontiguousarray(data).nbytes)


def _row_spans(region, idx) -> list[tuple[int, int]]:
    """Byte spans of rows[idx] of a region; whole-region fallback when the
    geometry can't be derived."""
    try:
        rows = int(region.shape[0])
        row_bytes = int(region.nbytes) // rows
        ii = sorted({int(i) for i in np.asarray(idx).reshape(-1).tolist()})
        if not ii:
            return []
    except Exception:
        return [(int(region.off), int(region.off) + int(region.nbytes))]
    spans = []
    base = int(region.off)
    run_s = prev = ii[0]
    for i in ii[1:]:
        if i != prev + 1:
            spans.append((base + run_s * row_bytes,
                          base + (prev + 1) * row_bytes))
            run_s = i
        prev = i
    spans.append((base + run_s * row_bytes, base + (prev + 1) * row_bytes))
    return spans


class CheckedPool:
    """Crash-consistency-checking wrapper over any pool backend.

    Intercepts the data-path and lifecycle ops to feed a
    :class:`ShadowTracker`; everything else (metrics, wire stats, proxy
    surface it doesn't model) is delegated verbatim. Composes over local
    devices (dram/pmem — full directory tracking by parsing the superblock
    the allocator writes) and proxy devices (remote/sharded — lifecycle
    tracked at the proxy call boundary, nmp effects modeled per kind)."""

    def __init__(self, inner, name: Optional[str] = None):
        self.__dict__["_inner"] = inner
        self.__dict__["tracker"] = ShadowTracker(
            name or f"checked:{type(inner).__name__}")
        self.__dict__["_is_local"] = not getattr(inner, "remote", False)
        self.__dict__["_dir_seq"] = -1
        self.__dict__["_dir_entries"] = {}
        if self._is_local:
            self._resync_directory()

    # -- attribute plumbing ----------------------------------------------------
    def __getattr__(self, name):
        try:
            inner = self.__dict__["_inner"]
        except KeyError:
            raise AttributeError(name) from None
        return getattr(inner, name)

    def __setattr__(self, name, value):
        # the manager/tests configure the *device* through these knobs after
        # construction (pool.faults = ..., pool.epoch_sink = ...)
        if name in _FORWARD_SET and "_inner" in self.__dict__:
            setattr(self.__dict__["_inner"], name, value)
        else:
            self.__dict__[name] = value

    def __repr__(self):
        return f"CheckedPool({self._inner!r})"

    @property
    def inner(self):
        return self._inner

    # -- local directory shadow ------------------------------------------------
    def _parse_directory(self):
        from repro_torch.pool import allocator as al
        inner = self._inner
        best = None
        for slot in (0, 1):
            lo = slot * al.SUPER_SLOT
            if lo + al.SUPER_SLOT > len(inner._cache):
                continue
            # read the raw cache: a tracked read here would pollute the
            # device metrics the benches assert on
            parsed = al._unpack(inner._cache[lo:lo + al.SUPER_SLOT])
            if parsed is not None and (best is None or parsed[0] > best[0]):
                best = parsed
        if best is None:
            return None
        seq, payload = best
        doc = json.loads(bytes(payload).decode("utf-8"))
        ents = {}
        for domkey, regs in doc.get("domains", {}).items():
            for rname, ent in regs.items():
                ents[(domkey, rname)] = (int(ent["off"]), int(ent["nbytes"]))
        return seq, ents

    def _scan_directory(self):
        """Diff the freshly written superblock against the shadow: new
        entries are allocs, vanished entries are frees."""
        parsed = self._parse_directory()
        if parsed is None:
            return
        seq, ents = parsed
        if seq == self._dir_seq:
            return
        old = self._dir_entries
        t = self.tracker
        for key, (off, n) in ents.items():
            if key not in old:
                t.note_alloc(key, off, n)
            elif old[key] != (off, n):
                o_off, o_n = old[key]
                t.note_free(key, o_off, o_n, strict=False)
                t.note_alloc(key, off, n)
        for key, (off, n) in old.items():
            if key not in ents:
                t.note_free(key, off, n)
        self.__dict__["_dir_seq"] = seq
        self.__dict__["_dir_entries"] = ents

    def _resync_directory(self):
        """After a power cycle the media-elected directory is the truth:
        entries it holds are live (even if we saw them freed in the lost
        epoch); entries it lost were never durable."""
        parsed = self._parse_directory()
        t = self.tracker
        if parsed is None:
            self.__dict__["_dir_seq"] = -1
            self.__dict__["_dir_entries"] = {}
            t.live = {}
            return
        seq, ents = parsed
        for off, n in ents.values():
            t.freed.sub(off, off + n)
        t.live = {key: (off, n) for key, (off, n) in ents.items()}
        self.__dict__["_dir_seq"] = seq
        self.__dict__["_dir_entries"] = dict(ents)

    def _after_local_write(self, off: int, nbytes: int):
        if not self._is_local:
            return
        from repro_torch.pool.allocator import DATA_START
        if off < DATA_START:
            self._scan_directory()

    # -- data path -------------------------------------------------------------
    def read(self, off: int, nbytes: int, tag: str = "read"):
        self.tracker.note_read(off, nbytes, what=f"read[{tag}]")
        return self._inner.read(off, nbytes, tag=tag)

    def view(self, off: int, nbytes: int):
        self.tracker.note_read(off, nbytes, what="view")
        return self._inner.view(off, nbytes)

    def read_async(self, off: int, nbytes: int, tag: str = "read"):
        self.tracker.note_read(off, nbytes, what=f"read_async[{tag}]")
        return self._inner.read_async(off, nbytes, tag=tag)

    def read_batch(self, reqs, tag: str = "read"):
        for off, nbytes in reqs:
            self.tracker.note_read(off, nbytes, what=f"read_batch[{tag}]")
        return self._inner.read_batch(reqs, tag=tag)

    def write(self, off: int, data, tag: str = "write"):
        nbytes = _buf_len(data)
        self.tracker.note_write(off, nbytes, what=f"write[{tag}]")
        self._inner.write(off, data, tag=tag)
        self._after_local_write(off, nbytes)

    def write_async(self, off: int, data, tag: str = "write"):
        nbytes = _buf_len(data)
        self.tracker.note_write(off, nbytes, what=f"write_async[{tag}]")
        fut = self._inner.write_async(off, data, tag=tag)
        self._after_local_write(off, nbytes)
        return fut

    def mark_dirty(self, off: int, nbytes: int):
        self.tracker.note_write(off, nbytes, what="mark_dirty")
        self._inner.mark_dirty(off, nbytes)

    def persist(self, off: Optional[int] = None, nbytes: Optional[int] = None,
                point: str = "persist"):
        lo = 0 if off is None else int(off)
        hi = self._inner.capacity if nbytes is None else lo + int(nbytes)
        self.tracker.note_persist(lo, hi, point=point)
        self._inner.persist(off, nbytes, point=point)

    # -- failure ---------------------------------------------------------------
    def crash(self):
        self.tracker.note_crash()
        self._inner.crash()
        if self._is_local:
            self._resync_directory()

    def crash_shard(self, i: int):
        from repro_torch.pool.sharded import SHARD_SPAN
        self.tracker.note_crash(window=(i * SHARD_SPAN,
                                        (i + 1) * SHARD_SPAN))
        return self._inner.crash_shard(i)

    # -- near-memory ops -------------------------------------------------------
    def nmp_batch(self, calls):
        if self._is_local:
            # run the registry locally THROUGH the wrapper so every granular
            # view/mark_dirty/persist stays tracked
            from repro_torch.pool.device import PoolDevice
            return PoolDevice.nmp_batch(self, calls)
        for kind, region, kw in calls:
            self._model_nmp_reads(kind, region, kw.get("idx"))
        out = self._inner.nmp_batch(calls)
        for kind, region, kw in calls:
            self._model_nmp_writes(kind, region, crashed_at=None, **kw)
        return out

    def nmp(self, kind: str, region, idx=None, rows=None, blob=None,
            combine: str = "sum", point: Optional[str] = None,
            log_region=None, **extra):
        from repro_torch.pool.faults import InjectedCrash
        fn = self._inner.nmp    # AttributeError on local backends, as inner
        self._model_nmp_reads(kind, region, idx)
        try:
            out = fn(kind, region, idx=idx, rows=rows, blob=blob,
                     combine=combine, point=point, log_region=log_region,
                     **extra)
        except InjectedCrash as e:
            self._model_nmp_writes(kind, region, idx=idx, rows=rows,
                                   point=point, log_region=log_region,
                                   crashed_at=str(e.args[0]) if e.args
                                   else "", **extra)
            raise
        self._model_nmp_writes(kind, region, idx=idx, rows=rows, point=point,
                               log_region=log_region, crashed_at=None,
                               **extra)
        return out

    def _model_nmp_reads(self, kind, region, idx):
        t = self.tracker
        if kind in ("gather", "bag_gather", "undo_snapshot"):
            for s, e in _row_spans(region, idx):
                t.note_read(s, e - s, what=f"nmp[{kind}]")
        elif kind in ("slot_headers", "region_export"):
            t.note_read(region.off, region.nbytes, what=f"nmp[{kind}]")
        elif kind == "undo_log_append":
            # pre-image capture reads mirror rows
            for s, e in _row_spans(region, idx):
                t.note_read(s, e - s, what="nmp[undo_log_append]")

    def _model_nmp_writes(self, kind, region, idx=None, rows=None,
                          point=None, log_region=None, crashed_at=None,
                          **extra):
        """Shadow effects of server-side mutation: the node wrote + persisted
        these bytes on our behalf."""
        t = self.tracker

        def write_covered(lo, hi, pt, what):
            t.note_write(lo, hi - lo, what=what)
            t.note_persist(lo, hi, point=pt)

        span = (int(region.off), int(region.off) + int(region.nbytes))
        if kind in ("region_import", "blob_put", "slot_clear"):
            defaults = {"region_import": "migrate-import",
                        "blob_put": "dense-blob", "slot_clear": "undo-gc"}
            write_covered(*span, point or defaults[kind], f"nmp[{kind}]")
        elif kind in ("row_update", "scatter_add"):
            for s, e in _row_spans(region, idx):
                t.note_write(s, e - s, what=f"nmp[{kind}]")
            t.note_persist(*span, point=point or "persist")
        elif kind == "undo_log_append":
            slot_off = int(extra.get("slot_off", 0))
            slot_bytes = int(extra.get("slot_bytes", 0))
            if slot_bytes > 0:
                # the node ran both paper barriers over the slot
                write_covered(slot_off, slot_off + slot_bytes,
                              "undo-payload", "nmp[undo_log_append]")
            if rows is not None and \
                    crashed_at != "tier_e.between-commit-and-apply":
                for s, e in _row_spans(region, idx):
                    t.note_write(s, e - s, what="nmp[undo_log_append]")
                t.note_persist(*span, point=point or "mirror-apply")

    # -- proxy allocator surface (remote/sharded) ------------------------------
    def alloc_region(self, domain: str, name: str, shape, dtype: str,
                     point: str = "superblock"):
        ent = self._inner.alloc_region(domain, name, shape, dtype, point)
        self.tracker.note_alloc((domain, name), ent["off"], ent["nbytes"])
        return ent

    def alloc_regions(self, domain: str, specs, point: str = "superblock"):
        ents = self._inner.alloc_regions(domain, specs, point)
        for (name, _shape, _dtype), ent in zip(specs, ents, strict=True):
            self.tracker.note_alloc((domain, name), ent["off"],
                                    ent["nbytes"])
        return ents

    def get_region(self, domain: str, name: str):
        ent = self._inner.get_region(domain, name)
        if ent is not None:
            self.tracker.note_alloc((domain, name), ent["off"],
                                    ent["nbytes"], strict=False)
        return ent

    def list_regions(self, domain: str):
        regs = self._inner.list_regions(domain)
        for name, ent in regs.items():
            self.tracker.note_alloc((domain, name), ent["off"],
                                    ent["nbytes"], strict=False)
        return regs

    def _free_tracked(self, match, strict: bool):
        t = self.tracker
        for key in [k for k in t.live if match(k)]:
            off, n = t.live[key]
            t.note_free(key, off, n, strict=strict)

    def free_remote_domain(self, domain: str, point: str = "superblock"):
        ok = self._inner.free_remote_domain(domain, point)
        # when the node had nothing (already swept), drop stale shadow
        # entries without the double-free check
        self._free_tracked(lambda k: k[0] == domain, strict=bool(ok))
        return ok

    def free_remote_region(self, domain: str, name: str,
                           point: str = "superblock"):
        ok = self._inner.free_remote_region(domain, name, point)
        self._free_tracked(lambda k: k == (domain, name), strict=bool(ok))
        return ok

    # -- migration / replication (sharded) -------------------------------------
    def migrate_domain(self, *args, **kwargs):
        res = self._inner.migrate_domain(*args, **kwargs)
        from repro_torch.pool.sharded import SHARD_SPAN
        t = self.tracker
        dst = int(res.get("dst", -1)) if isinstance(res, dict) else -1
        for dom in (res.get("moved", ()) if isinstance(res, dict) else ()):
            # the source copies are GC'd after the epoch flip: any further
            # access through a stale (pre-rebind) handle is use-after-free
            self._free_tracked(
                lambda k, d=dom: k[0] == d and
                (dst < 0 or t.live[k][0] // SHARD_SPAN != dst),
                strict=False)
        return res

    def replicate_domain(self, *args, **kwargs):
        return self._inner.replicate_domain(*args, **kwargs)

    def sweep_stale_domains(self):
        res = self._inner.sweep_stale_domains()
        from repro_torch.pool.sharded import SHARD_SPAN
        t = self.tracker
        for dom, idx in res:
            self._free_tracked(
                lambda k, d=dom, i=idx: k[0] == d and
                t.live[k][0] // SHARD_SPAN == i,
                strict=False)
        return res
