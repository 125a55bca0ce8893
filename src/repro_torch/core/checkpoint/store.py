"""CRC-verified array and tree blobs, and atomic JSON files (counterpart of
``repro.core.checkpoint.store``; the bytes are the JAX package's).

A blob leaf may be a numpy array or a torch tensor (on any device; it is
copied to the host). Its header names the dtype as numpy does. bf16 has no
numpy type without ``ml_dtypes``, which the port does not use: a bf16
tensor is written under the name ``"bfloat16"`` with its raw 16-bit
patterns, exactly what the JAX package writes for an ``ml_dtypes`` bf16
array, and a ``"bfloat16"`` leaf reads back as those bits viewed as
``torch.bfloat16``. Decoded leaves are CPU tensors.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any

import numpy as np
import torch

_MAGIC = b"RPR1"
CHUNK = 4 << 20  # 4 MiB
BF16 = "bfloat16"


class CorruptError(RuntimeError):
    pass


def _fsync_file(f):
    f.flush()
    os.fsync(f.fileno())


def fsync_dir(path: str):
    """fsync a directory so a just-published rename itself is durable."""
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _host_array(arr) -> tuple[str, list, np.ndarray]:
    """(dtype name, shape, host array holding the element bits) of a leaf."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            return BF16, list(t.shape), t.view(torch.int16).numpy()
        a = t.numpy()
    else:
        a = np.asarray(arr)
    return str(a.dtype), list(a.shape), a


def serialize_array(arr) -> bytes:
    """CRC-chunked wire form of one array: magic, JSON header, then
    [len | crc | payload] chunks of at most ``CHUNK`` bytes."""
    dtype, shape, a = _host_array(arr)
    header = {"dtype": dtype, "shape": shape}
    raw = np.ascontiguousarray(a).tobytes()
    hj = json.dumps(header).encode()
    out = [_MAGIC, struct.pack("<I", len(hj)), hj]
    for off in range(0, max(len(raw), 1), CHUNK):
        chunk = raw[off:off + CHUNK]
        out.append(struct.pack("<II", len(chunk), zlib.crc32(chunk)))
        out.append(chunk)
    return b"".join(out)


def deserialize_array(buf: bytes, off: int = 0,
                      name: str = "<blob>") -> tuple[torch.Tensor, int]:
    """Decode one serialize_array record at `off`; returns (tensor, next_off)."""
    if buf[off:off + 4] != _MAGIC:
        raise CorruptError(f"{name}: bad magic")
    (hlen,) = struct.unpack_from("<I", buf, off + 4)
    header = json.loads(buf[off + 8:off + 8 + hlen])
    off += 8 + hlen
    bf16 = header["dtype"] == BF16
    dtype = np.dtype(np.int16) if bf16 else np.dtype(header["dtype"])
    total = int(np.prod(header["shape"])) * dtype.itemsize
    # mirror the writer exactly: a 0-byte array still emits one (empty)
    # chunk record, which must be consumed to keep blob records aligned
    n_records = max(1, -(-total // CHUNK))
    out = bytearray()
    for _ in range(n_records):
        if off + 8 > len(buf):
            raise CorruptError(f"{name}: truncated")
        clen, crc = struct.unpack_from("<II", buf, off)
        chunk = buf[off + 8:off + 8 + clen]
        if len(chunk) != clen or zlib.crc32(chunk) != crc:
            raise CorruptError(f"{name}: chunk CRC mismatch")
        out.extend(chunk)
        off += 8 + clen
    if len(out) != total:
        raise CorruptError(f"{name}: truncated")
    t = torch.from_numpy(np.frombuffer(out, dtype=dtype)
                         .reshape(header["shape"]))
    return (t.view(torch.bfloat16) if bf16 else t), off


_TREE_MAGIC = b"RPTR"


def serialize_tree(tree: Any, extra_meta: dict | None = None) -> bytes:
    """Whole-tree blob (the pool's dense snapshots): a CRC'd key directory
    followed by per-array serialize_array records. Dict keys go in the
    order the dicts hold them."""
    flat = _flatten(tree)
    entries = [serialize_array(arr) for arr in flat.values()]
    meta = {"keys": list(flat.keys()), "lens": [len(e) for e in entries],
            "extra": extra_meta or {}}
    mj = json.dumps(meta).encode()
    head = _TREE_MAGIC + struct.pack("<II", len(mj), zlib.crc32(mj)) + mj
    return head + b"".join(entries)


def deserialize_tree(buf: bytes) -> tuple[Any, dict]:
    if buf[:4] != _TREE_MAGIC:
        raise CorruptError("tree blob: bad magic")
    mlen, mcrc = struct.unpack_from("<II", buf, 4)
    mj = buf[12:12 + mlen]
    if len(mj) != mlen or zlib.crc32(mj) != mcrc:
        raise CorruptError("tree blob: meta CRC mismatch")
    meta = json.loads(mj)
    off = 12 + mlen
    flat = {}
    for key in meta["keys"]:
        flat[key], off = deserialize_array(buf, off, name=key)
    return _unflatten(flat), meta.get("extra", {})


def _flatten(tree: Any, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
        if len(tree) == 0:
            out[prefix + "@empty"] = np.zeros((0,))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: dict) -> Any:
    # rebuild nested dict/list structure from path keys
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def conv(node):
        if not isinstance(node, dict):
            return node
        if "@empty" in node:
            return ()
        keys = list(node.keys())
        if keys and all(k.startswith("#") for k in keys):
            items = sorted(((int(k[1:]), v) for k, v in node.items()))
            return [conv(v) for _, v in items]
        return {k: conv(v) for k, v in node.items()}

    return conv(root)


def write_json_atomic(path: str, obj: dict):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        _fsync_file(f)
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
