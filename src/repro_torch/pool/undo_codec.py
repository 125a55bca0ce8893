"""Undo-log slot media format (counterpart of ``repro.pool.undo_codec``, byte
for byte), shared by the near-memory executor
(``pool/nmp.py`` — the server-side capture path) and the host-side ring
manager (``core/checkpoint/undo_log.py``).

Slot layout for step N:

    header  step i64 | n i64 | d i64 | flags i64 | stored_len i64
            | payload-crc u32 | commit u32
    payload stored_len bytes (possibly compressed — see flags)

Raw (uncompressed) payload layout:

    idx int64[n] | old_rows f32[n, d] | (old_acc f32[n, d])

``flags`` carries ``FLAG_ACC`` plus the compression mode in bits 4..7. The
CRC is computed **over the stored bytes** (compressed or not), so a torn
payload is rejected without decompressing garbage. The COMMIT word stays the
last 4 bytes of the header — its own persist barrier, exactly as before.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from repro_torch.pool import compress as pc
from repro_torch.pool.device import PoolError

HDR = struct.Struct("<qqqqqII")   # step, n, d, flags, stored_len, crc, commit
COMMIT_OFF = HDR.size - 4
COMMIT_SET = struct.pack("<I", 1)
COMMIT_CLEAR = struct.pack("<I", 0)

FLAG_ACC = 1
_MODE_SHIFT = 4      # bits 4..7 of flags carry compress.MODE_ID


def raw_payload_nbytes(n: int, d: int, has_acc: bool) -> int:
    return n * 8 + n * d * 4 * (2 if has_acc else 1)


def slot_nbytes(n: int, d: int, has_acc: bool) -> int:
    """Raw (worst-case) slot footprint — compression only ever shrinks the
    stored payload, so sizing rings by the raw need is always safe."""
    return HDR.size + raw_payload_nbytes(n, d, has_acc)


def _flags(has_acc: bool, mode: str) -> int:
    return (FLAG_ACC if has_acc else 0) | (pc.MODE_ID[mode] << _MODE_SHIFT)


def flags_mode(flags: int) -> str:
    return pc.ID_MODE.get(flags >> _MODE_SHIFT, "none")


def encode_payload(idx: np.ndarray, rows: np.ndarray,
                   acc: Optional[np.ndarray],
                   mode: str = "zlib") -> tuple[bytes, int, int]:
    """Returns (stored_payload, flags, raw_len). ``int8`` keeps the indices
    lossless and quantises only the row images; ``zlib`` DEFLATEs the whole
    raw payload; either falls back to ``none`` when it does not shrink."""
    pc.check_mode(mode)
    idx = np.ascontiguousarray(idx, np.int64).reshape(-1)
    rows = np.ascontiguousarray(rows, np.float32).reshape(idx.size, -1)
    has_acc = acc is not None
    parts = [idx.tobytes(), rows.tobytes()]
    if has_acc:
        acc = np.ascontiguousarray(acc, np.float32).reshape(idx.size, -1)
        parts.append(acc.tobytes())
    raw = b"".join(parts)
    if mode == "zlib":
        stored, eff = pc.encode_bytes("zlib", raw)   # falls back to "none"
        return stored, _flags(has_acc, eff), len(raw)
    if mode == "int8":
        parts = [idx.tobytes(), pc.int8_pack_rows(rows)]
        if has_acc:
            parts.append(pc.int8_pack_rows(acc))
        stored = b"".join(parts)
        if len(stored) < len(raw):
            return stored, _flags(has_acc, "int8"), len(raw)
    return raw, _flags(has_acc, "none"), len(raw)


def decode_payload(stored: bytes, n: int, d: int, flags: int):
    """Inverse of ``encode_payload``: (idx, rows, acc-or-None)."""
    has_acc = bool(flags & FLAG_ACC)
    mode = flags_mode(flags)
    if mode == "zlib":
        stored = zlib.decompress(stored)
        mode = "none"
    if mode == "int8":
        idx = np.frombuffer(stored, np.int64, n)
        off = n * 8
        per = pc.int8_rows_nbytes(n, d)
        rows = pc.int8_unpack_rows(stored[off:off + per], n, d)
        acc = (pc.int8_unpack_rows(stored[off + per:off + 2 * per], n, d)
               if has_acc else None)
        return idx, rows, acc
    idx = np.frombuffer(stored, np.int64, n)
    rows = np.frombuffer(stored, np.float32, n * d, offset=n * 8) \
        .reshape(n, d)
    acc = None
    if has_acc:
        acc = np.frombuffer(stored, np.float32, n * d,
                            offset=n * 8 + n * d * 4).reshape(n, d)
    return idx, rows, acc


def pack_slot(step: int, idx: np.ndarray, rows: np.ndarray,
              acc: Optional[np.ndarray], mode: str = "zlib",
              slot_bytes: Optional[int] = None) -> tuple[bytes, int, int]:
    """Full slot image with COMMIT **clear** (the commit word gets its own
    write + barrier). Returns (buf, stored_len, raw_len)."""
    stored, flags, raw_len = encode_payload(idx, rows, acc, mode)
    n = int(np.asarray(idx).size)
    d = int(np.asarray(rows).reshape(n, -1).shape[-1]) if n else 0
    buf = HDR.pack(step, n, d, flags, len(stored),
                   zlib.crc32(stored), 0) + stored
    if slot_bytes is not None and len(buf) > slot_bytes:
        raise PoolError(f"undo entry ({len(buf)}B) overflows slot "
                        f"({slot_bytes}B)")
    return buf, len(stored), raw_len


def write_slot(device, off: int, buf: bytes, tag: str = "undo"):
    """THE slot-commit protocol, shared by the host-driven ring writer and
    the near-memory executor so the two paths can never diverge: write the
    packed slot (COMMIT clear), persist exactly the written bytes
    (``undo-payload`` barrier), then set the COMMIT word under its own
    barrier (``undo-commit`` — the paper's persistent flag, step 2)."""
    device.write(off, buf, tag=tag)
    device.persist(off, len(buf), point="undo-payload")
    device.write(off + COMMIT_OFF, COMMIT_SET, tag=tag)
    device.persist(off + COMMIT_OFF, 4, point="undo-commit")


def parse_header(raw: bytes, slot_bytes: int):
    """Validated header probe: (step, n, d, flags, stored_len) for a
    committed, in-bounds entry, else None."""
    step, n, d, flags, stored_len, crc, commit = HDR.unpack(raw[:HDR.size])
    if commit != 1 or n < 0 or d <= 0 or stored_len < 0:
        return None
    if HDR.size + stored_len > slot_bytes:
        return None
    return step, n, d, flags, stored_len, crc
