"""Named persistence domains + region allocation over a ``PoolDevice``
(counterpart of ``repro.pool.allocator``).

Layout:

    [superblock slot A | superblock slot B | data ...]

The superblock is the recovery-time directory: a JSON map of
``domain -> region -> (offset, nbytes, dtype, shape)`` plus the bump
allocation pointer, written alternately to two CRC'd slots with a sequence
number (classic A/B update), so a crash mid-directory-write always leaves one
valid slot. ``PoolAllocator(device)`` opens an existing directory if the
magic is present, else formats a fresh one: the same constructor serves
cold start and post-crash recovery. The bytes are the JAX package's.

Domains are the paper's persistent regions: the embedding *data region*
(mirror), the *log region* (undo ring), the manifest, and dense snapshot
slots all live in separate domains of one pool.

``JsonRegion`` layers the same A/B trick inside a single region for small,
frequently-rewritten metadata (the manifest).

``PoolAllocator(device, readonly=True)`` is the serving tier's posture: it
may reopen regions that exist, and anything that would change the
directory (a new region, a free) raises ``TenantIsolationError``. Over a
remote device the posture also rides on the connection's hello, and the
memory node enforces it on the wire.

Multi-tenancy: ``PoolAllocator(device, tenant="a", quota=...)`` namespaces
every domain under ``a::<domain>`` in the shared directory, so several
trainers carve disjoint regions out of one memory node. A non-zero quota
bounds the tenant's allocated bytes (``QuotaExceededError``), and
``owned_ranges()`` is the byte-range view the node checks raw reads and
writes against. With a remote device the allocator is a thin proxy: alloc,
get, regions and free are wire ops run by the node's tenant-scoped
allocator, and the regions it returns read and write through the remote
device.
"""
from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.pool.device import (PoolDevice, PoolError,
                                     QuotaExceededError,
                                     TenantIsolationError)

_MAGIC = b"RPPL"
SUPER_SLOT = 32 << 10
DATA_START = 2 * SUPER_SLOT
_ALIGN = 64
_HDR = struct.Struct("<4sQII")     # magic, seq, len, crc


def _crc(seq: int, payload: bytes) -> int:
    # the CRC binds payload AND seq: a torn header that mixes a new seq with
    # an old payload/CRC must not elect as the newest valid slot
    return zlib.crc32(payload + struct.pack("<Q", seq))


def _pack(seq: int, payload: bytes) -> bytes:
    return _HDR.pack(_MAGIC, seq, len(payload), _crc(seq, payload)) + payload


def _unpack(buf: np.ndarray) -> Optional[tuple[int, bytes]]:
    raw = bytes(buf[:_HDR.size])
    magic, seq, length, crc = _HDR.unpack(raw)
    if magic != _MAGIC or length > buf.size - _HDR.size:
        return None
    payload = bytes(buf[_HDR.size:_HDR.size + length])
    if _crc(seq, payload) != crc:
        return None
    return seq, payload


@dataclass
class Region:
    device: PoolDevice
    domain: str
    name: str
    off: int
    nbytes: int
    dtype: str
    shape: tuple

    def read_array(self, tag: str = "read") -> np.ndarray:
        buf = self.device.read(self.off, self.nbytes, tag=tag)
        return np.frombuffer(bytes(buf), dtype=self.dtype).reshape(self.shape)

    def write_array(self, arr: np.ndarray, tag: str = "write"):
        arr = np.ascontiguousarray(arr, dtype=self.dtype)
        if arr.nbytes > self.nbytes:
            raise PoolError(f"{self.domain}/{self.name}: write {arr.nbytes}B "
                            f"> region {self.nbytes}B")
        self.device.write(self.off, arr, tag=tag)

    def view_array(self) -> np.ndarray:
        """Writable zero-copy view of the region cache, shaped. The caller
        must ``mark_dirty`` mutated rows (the nmp layer does)."""
        return self.device.view(self.off, self.nbytes) \
            .view(self.dtype).reshape(self.shape)

    def mark_dirty(self, rel_off: int = 0, nbytes: Optional[int] = None):
        self.device.mark_dirty(self.off + rel_off,
                               self.nbytes - rel_off if nbytes is None
                               else nbytes)

    def persist(self, point: str = "persist"):
        self.device.persist(self.off, self.nbytes, point=point)


class Domain:
    def __init__(self, alloc: "PoolAllocator", name: str):
        self._alloc = alloc
        self.name = name

    def alloc(self, name: str, *, shape, dtype="float32",
              point: str = "superblock") -> Region:
        return self._alloc._alloc(self.name, name, shape, dtype, point)

    def get(self, name: str) -> Optional[Region]:
        return self._alloc._get(self.name, name)

    def regions(self) -> dict[str, Region]:
        return self._alloc._regions(self.name)

    def free(self, point: str = "superblock") -> bool:
        return self._alloc.free_domain(self.name, point=point)

    def free_region(self, name: str, point: str = "superblock") -> bool:
        return self._alloc._free_region(self.name, name, point)


class PoolAllocator:
    def __init__(self, device: PoolDevice, tenant: Optional[str] = None,
                 quota: int = 0, readonly: bool = False):
        self.device = device
        self.tenant = tenant
        self.quota = int(quota)
        # read-only posture (the serving tier); a readonly remote connection
        # makes its allocators readonly too
        self.readonly = bool(readonly) or bool(getattr(device, "readonly",
                                                       False))
        if getattr(device, "remote", False):
            # proxy mode: the node's tenant-scoped allocator owns the
            # directory; every alloc/get/regions/free is a wire op
            self._proxy = device
            self.seq = 0
            self.directory = {"alloc_ptr": DATA_START, "domains": {}}
            return
        self._proxy = None
        found = self._read_directory()
        if found is None:
            self.seq = 0
            self.directory = {"alloc_ptr": DATA_START, "domains": {}}
            device.ensure(DATA_START)
            self._write_directory()
        else:
            self.seq, self.directory = found

    def _key(self, dname: str) -> str:
        return f"{self.tenant}::{dname}" if self.tenant else dname

    # -- directory persistence ----------------------------------------------
    def _read_directory(self, newer_than: int = -1):
        """The newest valid directory slot as (seq, directory), or None if
        there is none newer than ``newer_than`` (then no JSON is parsed)."""
        if self.device.capacity < DATA_START:
            return None
        best = None
        for slot in range(2):
            buf = self.device.view(slot * SUPER_SLOT, SUPER_SLOT)
            got = _unpack(buf)
            if got and (best is None or got[0] > best[0]):
                best = got
        if best is None or best[0] <= newer_than:
            return None
        return best[0], json.loads(best[1].decode())

    def _sync(self):
        """Re-read the on-device directory if it advanced: several live
        allocator handles over one device (checkpoint manager, undo ring,
        recovery) must not hand out overlapping regions from stale copies."""
        if self._proxy is not None:
            return
        found = self._read_directory(newer_than=self.seq)
        if found is not None:
            self.seq, self.directory = found

    def _write_directory(self, point: str = "superblock"):
        self.seq += 1
        blob = _pack(self.seq, json.dumps(self.directory).encode())
        if len(blob) > SUPER_SLOT:
            raise PoolError("directory overflows superblock")
        slot = self.seq % 2
        self.device.write(slot * SUPER_SLOT, blob, tag="superblock")
        self.device.persist(slot * SUPER_SLOT, SUPER_SLOT, point=point)

    # -- regions -------------------------------------------------------------
    def _region(self, dname: str, rname: str, ent: dict) -> Region:
        return Region(self.device, dname, rname, ent["off"], ent["nbytes"],
                      ent["dtype"], tuple(ent["shape"]))

    def _alloc(self, dname: str, rname: str, shape, dtype: str,
               point: str) -> Region:
        shape = tuple(int(s) for s in np.atleast_1d(np.asarray(shape, int)))
        if self._proxy is not None:
            if self.readonly:      # a reopen only; the node checks it too
                ent = self._proxy.get_region(dname, rname)
                if not (ent and ent["dtype"] == dtype
                        and tuple(ent["shape"]) == shape):
                    raise TenantIsolationError(
                        f"readonly tenant: alloc of new region "
                        f"{dname}/{rname} denied (only idempotent reopens "
                        f"are allowed)")
            ent = self._proxy.alloc_region(dname, rname, shape, dtype, point)
            return self._region(dname, rname, ent)
        self._sync()
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        dom = self.directory["domains"].setdefault(self._key(dname), {})
        ent = dom.get(rname)
        if ent and ent["dtype"] == dtype and tuple(ent["shape"]) == shape:
            return self._region(dname, rname, ent)   # idempotent reopen
        if self.readonly:
            raise TenantIsolationError(
                f"readonly tenant: alloc of new region {dname}/{rname} "
                f"denied (only idempotent reopens are allowed)")
        if self.tenant and self.quota:
            # net growth: a reshaped region replaces (leaks) the old entry
            used = self.tenant_used() - (ent["nbytes"] if ent else 0)
            if used + nbytes > self.quota:
                raise QuotaExceededError(
                    f"tenant {self.tenant!r}: alloc {dname}/{rname} "
                    f"({nbytes}B) would exceed quota "
                    f"({used}B used of {self.quota}B)")
        off = -(-self.directory["alloc_ptr"] // _ALIGN) * _ALIGN
        self.device.ensure(off + nbytes)
        dom[rname] = {"off": off, "nbytes": nbytes, "dtype": dtype,
                      "shape": list(shape)}
        self.directory["alloc_ptr"] = off + nbytes
        self._write_directory(point)
        return self._region(dname, rname, dom[rname])

    def _get(self, dname: str, rname: str) -> Optional[Region]:
        if self._proxy is not None:
            ent = self._proxy.get_region(dname, rname)
            return self._region(dname, rname, ent) if ent else None
        self._sync()
        ent = self.directory["domains"].get(self._key(dname), {}).get(rname)
        return self._region(dname, rname, ent) if ent else None

    def _regions(self, dname: str) -> dict[str, Region]:
        if self._proxy is not None:
            ents = self._proxy.list_regions(dname)
        else:
            self._sync()
            ents = self.directory["domains"].get(self._key(dname), {})
        return {n: self._region(dname, n, e) for n, e in ents.items()}

    def _free_region(self, dname: str, rname: str, point: str) -> bool:
        """Drop ONE region's directory entry (its bytes are leaked, as in
        the emulator): a caller that outgrows a region frees, then
        allocates, so the directory never silently orphans the old entry."""
        if self.readonly:
            raise TenantIsolationError(
                f"readonly tenant: free of region {dname}/{rname} denied")
        if self._proxy is not None:
            return self._proxy.free_remote_region(dname, rname, point)
        self._sync()
        dom = self.directory["domains"].get(self._key(dname), {})
        if dom.pop(rname, None) is None:
            return False
        self._write_directory(point)
        return True

    def free_domain(self, dname: str, point: str = "superblock") -> bool:
        """Drop a domain's directory entries (the data bytes are leaked, as
        in the emulator)."""
        if self.readonly:
            raise TenantIsolationError(
                f"readonly tenant: free of domain {dname} denied")
        if self._proxy is not None:
            return self._proxy.free_remote_domain(dname, point)
        self._sync()
        if self.directory["domains"].pop(self._key(dname), None) is None:
            return False
        self._write_directory(point)
        return True

    def domain(self, name: str) -> Domain:
        return Domain(self, name)

    # -- tenancy -------------------------------------------------------------
    def _tenant_entries(self, tenant: Optional[str] = None):
        t = tenant if tenant is not None else self.tenant
        if t is None:
            for dom in self.directory["domains"].values():
                yield from dom.values()
            return
        pre = f"{t}::"
        for key, dom in self.directory["domains"].items():
            if key.startswith(pre):
                yield from dom.values()

    def tenant_used(self, tenant: Optional[str] = None) -> int:
        """Bytes currently allocated to ``tenant`` (quota accounting)."""
        self._sync()
        return sum(e["nbytes"] for e in self._tenant_entries(tenant))

    def used_bytes(self) -> int:
        """Live bytes across ALL tenants (the node-fill gauge). Counts
        directory entries, not the bump pointer."""
        if self._proxy is not None:
            raise PoolError("used_bytes is a node-side gauge")
        self._sync()
        return sum(e["nbytes"] for dom in self.directory["domains"].values()
                   for e in dom.values())

    def owned_ranges(self, tenant: Optional[str] = None) -> list[tuple]:
        """[start, end) byte ranges the tenant may address directly: the
        node checks every raw read/write/persist/nmp request against
        these."""
        self._sync()
        return [(e["off"], e["off"] + e["nbytes"])
                for e in self._tenant_entries(tenant)]

    def tenant_domains(self, tenant: Optional[str] = None) -> list[str]:
        """The tenant's domain names (every domain without a tenant)."""
        self._sync()
        t = tenant if tenant is not None else self.tenant
        if t is None:
            return list(self.directory["domains"])
        pre = f"{t}::"
        return [k[len(pre):] for k in self.directory["domains"] if
                k.startswith(pre)]


class JsonRegion:
    """Crash-atomic small-JSON store inside one region (A/B halves): each
    update lands in the half with the older sequence number, so the previous
    value stays readable until the new one is fully persisted."""

    def __init__(self, region: Region):
        if region.dtype != "uint8":
            raise PoolError("JsonRegion wants a uint8 region")
        self.region = region
        self.half = region.nbytes // 2

    @classmethod
    def create(cls, domain: Domain, name: str,
               nbytes: int = 8 << 10) -> "JsonRegion":
        return cls(domain.alloc(name, shape=(nbytes,), dtype="uint8"))

    def _slot_view(self, i: int) -> np.ndarray:
        return self.region.device.view(self.region.off + i * self.half,
                                       self.half)

    def read(self) -> Optional[dict]:
        best = None
        for i in range(2):
            got = _unpack(self._slot_view(i))
            if got and (best is None or got[0] > best[0]):
                best = got
        return json.loads(best[1].decode()) if best else None

    def read_seq(self) -> int:
        seqs = [got[0] for i in range(2)
                if (got := _unpack(self._slot_view(i)))]
        return max(seqs) if seqs else 0

    def write(self, obj: dict, point: str = "manifest"):
        seq = self.read_seq() + 1
        blob = _pack(seq, json.dumps(obj).encode())
        if len(blob) > self.half:
            raise PoolError("JsonRegion payload overflows slot")
        off = self.region.off + (seq % 2) * self.half
        self.region.device.write(off, blob, tag="manifest")
        self.region.device.persist(off, self.half, point=point)
