"""Pool-side compression codecs — the CXL controller's compression engine
(counterpart of ``repro.pool.compress``; the bytes it writes are the same).

The paper puts the checkpointing logic *near* the memory controller; this
module is the byte-level half of that claim: undo-log payloads and dense
snapshot blobs are compressed inside the memory node before they hit media,
so media bandwidth/energy (and, for reads, link bytes) shrink while the
trainer never sees a compressed byte.

Codecs (``MODES``):

  * ``none`` — identity (the knob's off position).
  * ``zlib`` — lossless DEFLATE; the default for both undo payloads and
    dense blobs because recovery must stay bit-identical.
  * ``int8`` — per-row scaled int8 quantisation of float32 row payloads
    (the ``distributed/compression.py`` int8 machinery, numpy-side).
    LOSSY: rollback restores rows only to quantisation error, so it is an
    explicitly relaxed mode (paper Fig. 9a-style bounded deviation), never
    the default. Row codecs fall back to ``zlib`` for non-row byte blobs.

``frame``/``unframe`` wrap an opaque blob (the serialized dense pytree) in a
small self-describing container: magic, mode, raw/stored lengths and a CRC
computed **over the compressed bytes** — a torn or bit-flipped stored blob is
detected before decompression is even attempted.

Compression busy time is modeled at ``COMPRESS_BPS`` and charged by the
callers in ``nmp.py`` to the metrics' dedicated compression-engine meter
(``comp_time_s`` — an IAA-class in-controller DEFLATE block, priced by
``sim/devices.POWER["comp_engine_w"]``, not the 15 W adder array).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from repro_torch.pool.device import PoolError

MODES = ("none", "zlib", "int8")
# the one mode<->id table; undo_codec flags and blob frames share it so a
# payload encoded by either side always decodes on the other
MODE_ID = {"none": 0, "zlib": 1, "int8": 2}
ID_MODE = {v: k for k, v in MODE_ID.items()}

COMPRESS_BPS = 4e9      # modeled near-memory (de)compression throughput


class BlobCorruptError(PoolError):
    """A framed blob failed its CRC/length checks — actual corruption, as
    opposed to transport or isolation failures (plain ``PoolError``
    subtypes), so recovery can downgrade exactly this case."""


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise PoolError(f"unknown pool compression mode {mode!r} "
                        f"(want one of {MODES})")
    return mode


# ---------------------------------------------------------------------------
# byte-blob codecs (dense snapshots, generic payloads)
# ---------------------------------------------------------------------------


def encode_bytes(mode: str, raw: bytes) -> tuple[bytes, str]:
    """Compress an opaque byte blob; returns (stored, effective_mode).
    Incompressible input falls back to ``none`` so stored <= raw always."""
    check_mode(mode)
    if mode == "zlib" or mode == "int8":    # int8 is a row codec; blobs: zlib
        stored = zlib.compress(raw, 6)
        if len(stored) < len(raw):
            return stored, "zlib"
    return raw, "none"


def decode_bytes(mode: str, stored: bytes) -> bytes:
    check_mode(mode)
    if mode == "zlib":
        return zlib.decompress(stored)
    if mode == "int8":
        raise PoolError("int8 is a row codec, not a byte-blob codec")
    return stored


# ---------------------------------------------------------------------------
# float32 row codecs (undo payload rows)
# ---------------------------------------------------------------------------


def int8_pack_rows(rows: np.ndarray) -> bytes:
    """Per-row scaled int8 quantisation: scale f32[n] | q int8[n, d]."""
    rows = np.ascontiguousarray(rows, np.float32)
    scale = (np.abs(rows).max(axis=1) / 127.0 + 1e-12).astype(np.float32)
    q = np.clip(np.round(rows / scale[:, None]), -127, 127).astype(np.int8)
    return scale.tobytes() + q.tobytes()


def int8_unpack_rows(stored: bytes, n: int, d: int) -> np.ndarray:
    scale = np.frombuffer(stored, np.float32, n)
    q = np.frombuffer(stored, np.int8, n * d, offset=n * 4)
    return (q.reshape(n, d).astype(np.float32) * scale[:, None])


def int8_rows_nbytes(n: int, d: int) -> int:
    return n * 4 + n * d


# ---------------------------------------------------------------------------
# framed blob container (CRC over the *stored* bytes)
# ---------------------------------------------------------------------------

_MAGIC = b"RPCB"
_FRAME = struct.Struct("<4sBxxxQQI")    # magic, mode, raw_len, stored_len, crc
FRAME_OVERHEAD = _FRAME.size


def frame(raw, mode: str = "zlib") -> bytes:
    """Wrap `raw` (any bytes-like buffer) in a self-describing compressed
    container."""
    stored, eff = encode_bytes(mode, raw)
    # bytes() is free when the codec already produced bytes (zlib path);
    # it materialises only an uncompressed memoryview passthrough
    return _FRAME.pack(_MAGIC, MODE_ID[eff], len(raw), len(stored),
                       zlib.crc32(stored)) + bytes(stored)


def unframe(buf: bytes) -> bytes:
    """Inverse of ``frame``. Bytes without the magic are passed through
    verbatim (legacy uncompressed blobs); a CRC mismatch over the stored
    bytes raises ``BlobCorruptError`` before any decompression runs."""
    buf = bytes(buf)
    if len(buf) < _FRAME.size or buf[:4] != _MAGIC:
        return buf
    _, mode_id, raw_len, stored_len, crc = _FRAME.unpack(buf[:_FRAME.size])
    stored = buf[_FRAME.size:_FRAME.size + stored_len]
    if len(stored) != stored_len or zlib.crc32(stored) != crc:
        raise BlobCorruptError(
            "compressed blob CRC mismatch (torn/corrupt frame)")
    try:
        raw = decode_bytes(ID_MODE.get(mode_id, "none"), stored)
    except zlib.error as e:
        raise BlobCorruptError(f"compressed blob inflate failed: {e}") from e
    if len(raw) != raw_len:
        raise BlobCorruptError(f"compressed blob length mismatch "
                               f"({len(raw)} != {raw_len})")
    return raw


def framed_len(raw_len: int) -> int:
    """Worst-case frame size for a raw blob (mode falls back to ``none``)."""
    return FRAME_OVERHEAD + raw_len
