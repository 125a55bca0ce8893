"""Pool wire protocol (counterpart of ``repro.pool.protocol``): framing,
the typed op registry, the pipelined channel.

This module is the single source of truth for the trainer <-> memory-node
wire API of the port: the client (``remote.RemotePool``) and the server
(``server.PoolServer``) import their op descriptors, error mapping, timeout
classes and framing from here. Every frame it builds is byte for byte the
JAX package's, so either package's client talks to the other's server.

Frame layout (both directions, little-endian)::

    u32 total | u32 hdr_len | hdr (UTF-8 JSON) | body (raw bytes)

``total`` counts everything after itself. Requests carry ``{"op": ...}``
plus op-specific fields; bulk payloads ride in ``body`` so arrays never
pass through JSON. No frame may exceed ``MAX_FRAME``; the client splits a
larger read or write into several frames (``remote.RemotePool``).

Version negotiation: the client's ``hello`` carries ``"wire": 3``; the
server replies with ``"wire": min(client, server)``. A v1 peer (no ``wire``
field) negotiates down to the strict request/response protocol, one
in-flight op per connection, fence-on-desync and all.

Wire v3 adds, on top of the v2 semantics, the zero-copy data path:

  * struct-packed binary headers for the data-class ops (read / write and
    the data nmp kinds, ``V3_CODECS``): the top bit of ``hdr_len`` flags a
    binary header, so binary data frames and JSON control/error frames
    interleave freely on one connection;
  * scatter-gather bodies end to end: frames are lists of ``memoryview``
    segments sent with vectored ``socket.sendmsg`` (``sendmsg_all``);
  * pooled receives: whole frames land in a reusable per-channel
    ``BufferPool`` buffer via ``recv_into`` and bodies surface as
    zero-copy views of the loaned buffer. A loan used after its channel
    recycled the buffer raises ``RecycledBufferError``;
  * copy meters: ``bytes_copied`` / ``data_frames`` on both sides (channel
    stats client-side, ``PoolMetrics`` server-side): 0 bytes copied per
    data op on the v3 path.

Wire v2 adds, on top of the v1 frame layout:

  * tagged frames: every request carries a ``rid`` correlation id that the
    server echoes, so many requests can be in flight per socket;
  * pipelining: ``PoolChannel`` keeps a reader thread matching replies to
    futures; the checkpoint writer thread, a serving tier and a commit
    tailer can share one connection;
  * no fence-on-desync: a failed op (typed error, per-request timeout,
    torn body inside an intact frame) rejects only its own future. Only
    broken framing (a corrupt length prefix, EOF mid-frame) kills a
    connection;
  * keepalive: an idle pipelined connection sends ``ping`` frames, so a
    quiet trainer is not mistaken for a dead peer;
  * scatter-gather batch frames: the ``batch`` op carries N sub-ops in ONE
    frame and returns N tagged sub-results in one reply.

Protocol reference (every op, from the registry below):

    op          class    mutating  control  body                result
    ----------- -------- --------- -------- ------------------- ----------------
    hello       control  -         -        -                   capacity, wire
    ping        control  -         -        -                   - (keepalive)
    read        data     -         -        -                   bytes
    write       data     yes       -        raw bytes           -
    persist     data     -         -        -                   -
    ensure      data     -         yes      -                   capacity
    capacity    control  -         -        -                   capacity
    crash       control  -         yes      -                   - (power cycle)
    set-faults  control  -         yes      -                   -
    alloc       data     reopen    -        -                   region entry
    get         control  -         -        -                   region entry
    regions     control  -         -        -                   {name: entry}
    domains     control  -         -        -                   [domain, ...]
    free        data     yes       -        -                   freed
    free-region data     yes       -        -                   freed
    metrics     control  -         all-scope -                  snapshot
    nmp         per-kind per-kind  -        idx|rows|blob       array/stats
    batch       bulk     per-sub   per-sub  concat sub-bodies   tagged results
    close       control  -         -        -                   - (hang up)

``nmp`` sub-kinds (``NMP_OPS``): gather, bag_gather, undo_snapshot,
slot_headers, row_update, scatter_add, undo_log_append, slot_clear,
region_export, region_import, blob_put, each with its own mutating flag
and timeout class (bulk for the region/blob movers). ``bag_gather``'s ids
are flat row ids of the region: a client holding stacked (T, R, d) tables
adds each table's row offset itself and names the region by its flat
(T*R, d) view, so both packages' servers reduce the same rows.

Timeout classes: ``control`` ops answer from directory state and time out
fast; ``data`` ops touch media; ``bulk`` ops move whole region images and
get the long leash, plus transfer time at ``Timeouts.BULK_BW_FLOOR``. A
single ``make_pool(..., timeout=...)`` rescales all three.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.pool.device import PoolError
from repro_torch.pool.faults import InjectedCrash

__all__ = [
    "BIN_HDR_FLAG", "DATA_OPS", "IDLE", "MAX_FRAME", "NMP_OPS", "OPS",
    "V3_CODECS", "WIRE_V1", "WIRE_V2", "WIRE_V3",
    "BufferPool", "BufferedSocket", "CompletedFuture", "Loan", "MappedFuture",
    "NmpSpec", "OpSpec", "PoolChannel", "PoolConnectionError", "PoolFuture",
    "PoolTimeoutError", "RecycledBufferError", "Timeouts", "V3Codec", "WireError", "error_to_frame",
    "format_addr", "frame_to_error", "pack_batch", "pack_batch_results",
    "pack_frame", "pack_frame_segments", "pack_v3_header",
    "pack_v3_reply_header", "parse_addr", "recv_frame", "recv_frame_pooled",
    "register_error", "send_frame", "sendmsg_all", "unpack_batch",
    "unpack_batch_results", "unpack_v3_header", "wire_from_env",
]

WIRE_V1 = 1
WIRE_V2 = 2
WIRE_V3 = 3

MAX_FRAME = 1 << 30          # anything larger is garbage, not a request
_LEN = struct.Struct("<I")
_HEAD = struct.Struct("<II")   # frame head: total length + header word

# v3 marks struct-packed binary headers by setting the top bit of the
# ``hdr_len`` word; JSON headers can never collide (MAX_FRAME caps a real
# header length far below 2^31), so binary data frames and JSON control
# frames interleave freely on one connection.
BIN_HDR_FLAG = 0x80000000

# the data-class wire ops: the frames whose bodies the zero-copy path (and
# the bytes_copied/data_frames meters on both sides) care about
DATA_OPS = frozenset({"read", "write", "nmp", "batch"})

# Sentinel recv_frame(idle_ok=True) returns when the socket timed out at a
# frame boundary: the peer is quiet, not dead.
IDLE = object()


class RecycledBufferError(Exception):
    """A loaned receive buffer was read after its channel recycled it (the
    JAX package raises its checker's class of the same name)."""


class WireError(PoolError):
    """Malformed, truncated, or oversized protocol frame. ``fatal`` says
    whether the byte stream lost frame sync (length prefix corrupt, EOF
    mid-frame) — a non-fatal instance means the offending frame was fully
    consumed and the connection can keep serving."""

    fatal = True


class PoolConnectionError(PoolError):
    """The peer vanished (refused, closed mid-op, or timed out)."""


class PoolTimeoutError(PoolConnectionError):
    """One pipelined request exceeded its per-op timeout class. Rejects
    only that request's future; the connection stays usable and a late
    reply is dropped by its correlation id."""


def _soft_wire_error(msg: str) -> WireError:
    e = WireError(msg)
    e.fatal = False
    return e


# ---------------------------------------------------------------------------
# addressing
# ---------------------------------------------------------------------------


def parse_addr(addr: str):
    """'unix:/path', 'tcp:host:port', or a bare filesystem path (unix)."""
    if addr.startswith("unix:"):
        return ("unix", addr[5:])
    if addr.startswith("tcp:"):
        host, _, port = addr[4:].rpartition(":")
        if not host or not port.isdigit():
            raise PoolError(f"bad tcp addr {addr!r} (want tcp:host:port)")
        return ("tcp", (host, int(port)))
    return ("unix", addr)


def format_addr(kind: str, target) -> str:
    if kind == "unix":
        return f"unix:{target}"
    return f"tcp:{target[0]}:{target[1]}"


def wire_from_env(default: int = WIRE_V3) -> int:
    """REPRO_POOL_WIRE={v1,v2,v3} pins the protocol generation both for
    clients and servers."""
    import os
    raw = os.environ.get("REPRO_POOL_WIRE", "").strip().lower()
    if raw in ("v1", "1"):
        return WIRE_V1
    if raw in ("v2", "2"):
        return WIRE_V2
    if raw in ("v3", "3"):
        return WIRE_V3
    return default


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


class BufferedSocket:
    """Read-side buffer over a socket: one large ``recv`` feeds many small
    frame reads. Under pipelining, back-to-back frames coalesce in the
    kernel buffer, so this collapses the 2-syscalls-per-frame pattern of
    header/body reads into ~1 syscall per burst. Exceptions (timeouts,
    EOF, OSError) propagate from the underlying socket untouched, so
    ``_recv_exact``'s idle/torn-frame semantics are preserved: a timeout
    with buffered bytes pending still means a stranded partial frame."""

    __slots__ = ("sock", "_buf")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = b""

    def recv(self, n: int) -> bytes:
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            return out
        chunk = self.sock.recv(max(n, 1 << 16))
        if len(chunk) <= n:
            return chunk
        self._buf = chunk[n:]
        return chunk[:n]

    def take_buffer(self) -> bytes:
        """Hand back (and clear) any buffered leftover — how a connection
        switching to the v3 pooled recv path avoids stranding bytes that a
        speculative recv already pulled out of the kernel."""
        out, self._buf = self._buf, b""
        return out


def _recv_exact(sock, n: int, *, at_boundary: bool = False,
                idle_ok: bool = False, stall_s: float = 0.0, on_stall=None):
    """Read exactly n bytes. Returns None on clean EOF at a frame boundary
    (only when at_boundary) and IDLE on a socket timeout with zero bytes
    read (only when idle_ok — a quiet pipelined connection, not a dead
    peer); raises WireError on EOF mid-frame and PoolConnectionError on
    socket-level failure, including a timeout that strands a partial
    frame. With ``stall_s`` a frame already begun survives socket
    timeouts until no byte has arrived for ``stall_s`` seconds; each such
    pause that is waited out is passed, in seconds, to ``on_stall``."""
    buf = bytearray()
    t_last = time.monotonic()
    stalled = False
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout as e:
            if idle_ok and at_boundary and not buf:
                return IDLE
            if _stalling(buf or not at_boundary, t_last, stall_s):
                stalled = True
                continue
            raise PoolConnectionError("timed out waiting for peer") from e
        except OSError as e:
            raise PoolConnectionError(str(e)) from e
        if not chunk:
            if at_boundary and not buf:
                return None
            raise WireError(f"peer closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
        stalled = _stall_ended(stalled, t_last, on_stall)
        t_last = time.monotonic()
    return bytes(buf)    # wire-copy: v1/v2 staging recv (v3 uses recv_into)


def _stalling(mid_frame, t_last: float, stall_s: float) -> bool:
    """Whether a socket timeout inside a frame is a stall to wait out: the
    channel's reader ticks at about a second (its keepalive and deadline
    clock), and a large reply body (a 64 MiB split read) may pause longer
    than that without its peer being gone."""
    return bool(mid_frame) and stall_s > 0 \
        and time.monotonic() - t_last < stall_s


def _stall_ended(stalled: bool, t_last: float, on_stall) -> bool:
    """Bytes came in: report the pause just waited out, if any (seconds
    since the last byte before it). Returns the new ``stalled`` flag."""
    if stalled and on_stall is not None:
        on_stall(time.monotonic() - t_last)
    return False


def _byteview(seg):
    """Zero-copy flat byte view over any contiguous buffer (bytes,
    bytearray, memoryview, ndarray). The scatter-gather paths speak only
    in these, so ``len()`` is always a byte count."""
    if isinstance(seg, (bytes, bytearray)):
        return seg
    m = seg if isinstance(seg, memoryview) else memoryview(seg)
    if m.format != "B" or m.ndim != 1:
        m = m.cast("B")
    return m


def _as_segment_list(body) -> list:
    """Normalize a frame body (bytes-like | ndarray | list of such) to a
    list of non-empty byte views without copying any of them."""
    segs = body if isinstance(body, list) else [body]
    out = []
    for s in segs:
        if s is None:
            continue
        v = _byteview(s)
        if len(v):
            out.append(v)
    return out


def pack_frame_segments(hdr: dict, body=b"", *, wire: int = WIRE_V2):
    """One frame -> ``([prefix, *body segments], wire_bytes)`` with no
    body copy: the prefix holds the length words plus the header (binary
    struct-packed on a v3 channel when the op has a ``V3_CODECS`` entry,
    JSON otherwise) and the body rides as the caller's own buffers, ready
    for ``sendmsg_all``."""
    segs = _as_segment_list(body)
    nbody = sum(len(s) for s in segs)
    bh = _v3_header(hdr) if wire >= WIRE_V3 else None
    if bh is not None:
        total = 4 + len(bh) + nbody
        if total > MAX_FRAME:
            raise WireError(f"frame too large ({total} bytes)")
        prefix = _LEN.pack(total) + _LEN.pack(len(bh) | BIN_HDR_FLAG) + bh
    else:
        hj = json.dumps(hdr).encode()
        total = 4 + len(hj) + nbody
        if total > MAX_FRAME:
            raise WireError(f"frame too large ({total} bytes)")
        prefix = _LEN.pack(total) + _LEN.pack(len(hj)) + hj
    return [prefix] + segs, total + 4


def pack_frame(hdr: dict, body=b"") -> bytes:
    """Encode one frame to its on-wire bytes (JSON header, joined body) —
    the v1/v2 compatibility form; the v3 data path ships
    ``pack_frame_segments`` output unjoined."""
    segs, _ = pack_frame_segments(hdr, body, wire=WIRE_V1)
    return b"".join(segs)    # wire-copy: v1/v2 peers take joined frames


def send_frame(sock: socket.socket, hdr: dict, body=b"") -> int:
    """Send one frame; returns the bytes put on the wire (framing
    included), the client channel's tx meter."""
    wire = pack_frame(hdr, body)
    try:
        sock.sendall(wire)
    except OSError as e:
        raise PoolConnectionError(str(e)) from e
    return len(wire)


# conservative segments-per-sendmsg window, well under every IOV_MAX
_IOV_CAP = 64


def tune_socket(sock: socket.socket, bufsize: int = 1 << 20):
    """Deepen the kernel send/recv buffers (best effort): a depth-8
    pipeline of 64 KiB frames overflows the ~208 KiB default, stalling
    the writer mid-burst and costing a context switch per stall."""
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, int(bufsize))
        except OSError:
            pass


def sendmsg_all(sock: socket.socket, segments: list):
    """Vectored sendall: put every segment on the wire in submission
    order without joining them — the v3 TX pump for the client cork and
    the server reply writer alike. Handles short writes by re-slicing
    views (never copying); falls back to per-segment sendall where the
    platform lacks ``sendmsg``."""
    send = getattr(sock, "sendmsg", None)
    if send is None:                                    # pragma: no cover
        for seg in segments:
            sock.sendall(seg)
        return
    for i in range(0, len(segments), _IOV_CAP):
        window = segments[i:i + _IOV_CAP]
        while window:
            sent = send(window)
            want = sum(len(s) for s in window)
            if sent == want:
                break
            rest = []
            for s in window:
                if sent >= len(s):
                    sent -= len(s)
                    continue
                rest.append(memoryview(s)[sent:] if sent else s)
                sent = 0
            window = rest


def recv_frame_sized(sock: socket.socket, *, idle_ok: bool = False,
                     stall_s: float = 0.0, on_stall=None):
    """Like ``recv_frame`` but returns (hdr, body, wire_bytes)."""
    head = _recv_exact(sock, 4, at_boundary=True, idle_ok=idle_ok,
                       stall_s=stall_s, on_stall=on_stall)
    if head is None:
        return None
    if head is IDLE:
        return IDLE
    (total,) = _LEN.unpack(head)
    if total < 4 or total > MAX_FRAME:
        # the length prefix itself is garbage: frame sync is gone for good
        raise WireError(f"bad frame length {total}")
    rest = _recv_exact(sock, total, stall_s=stall_s, on_stall=on_stall)
    # from here on the full frame was consumed — parse failures are soft:
    # the stream position is still exactly at the next frame boundary
    (hlen,) = _LEN.unpack(rest[:4])
    if hlen > total - 4:
        raise _soft_wire_error(
            f"header length {hlen} overruns frame ({total})")
    try:
        hdr = json.loads(rest[4:4 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise _soft_wire_error(f"bad frame header: {e}") from e
    if not isinstance(hdr, dict):
        raise _soft_wire_error("frame header is not an object")
    return hdr, rest[4 + hlen:], total + 4


def recv_frame(sock: socket.socket, *, idle_ok: bool = False):
    """Returns (hdr, body), None on clean EOF between frames, or IDLE on
    an idle-timeout tick (idle_ok only)."""
    got = recv_frame_sized(sock, idle_ok=idle_ok)
    if got is None or got is IDLE:
        return got
    hdr, body, _ = got
    return hdr, body


# ---------------------------------------------------------------------------
# buffer pool — reusable recv buffers with loan/generation accounting
# ---------------------------------------------------------------------------


class Loan:
    """One outstanding lease of a pool buffer. ``view()`` is the guarded
    access point: once the pool recycles the buffer (release + re-acquire
    potential), the loan's generation is stale and ``view()`` raises the
    checker's typed ``RecycledBufferError`` instead of aliasing bytes that
    now belong to another frame. ``detach()`` transfers ownership to the
    caller for good (how zero-copy result views escape the pool): the
    buffer is never recycled and the views stay valid for the buffer's
    GC lifetime."""

    __slots__ = ("pool", "buf", "nbytes", "gen", "detached")

    def __init__(self, pool: "BufferPool", buf: np.ndarray, nbytes: int,
                 gen: int):
        self.pool = pool
        self.buf = buf
        self.nbytes = nbytes
        self.gen = gen
        self.detached = False

    def valid(self) -> bool:
        if self.detached:
            return True
        return self.pool._gen_of(self.buf) == self.gen

    def view(self) -> memoryview:
        """Zero-copy view of the loaned bytes; typed violation once the
        channel has recycled the buffer out from under it."""
        if not self.valid():
            raise RecycledBufferError(
                f"loaned recv buffer ({self.nbytes}B, gen {self.gen}) used "
                f"after its channel recycled it — copy the view out before "
                f"releasing, or detach the loan")
        return memoryview(self.buf)[:self.nbytes]

    def detach(self):
        """Give the buffer to the current holder permanently (it will not
        return to the pool); outstanding views stay valid forever."""
        if not self.detached:
            self.pool._detach(self)
            self.detached = True

    def release(self):
        self.pool.release(self)


class BufferPool:
    """Reusable per-channel recv buffers. ``acquire(n)`` hands out a
    loaned uint8 buffer of at least ``n`` bytes (recycled from the freelist
    when one fits, freshly allocated otherwise); ``release`` bumps the
    buffer's generation and returns it for reuse, invalidating every
    outstanding ``Loan.view()`` on it. Single producer per channel, but
    thread-safe: reader threads release acks while user threads hold data
    loans."""

    def __init__(self, max_free: int = 8, default_size: int = 1 << 16):
        self.max_free = int(max_free)
        self.default_size = int(default_size)
        self._lock = threading.Lock()
        self._free: list[np.ndarray] = []
        self._gens: dict[int, int] = {}       # id(buf) -> generation
        self.acquired = 0
        self.reused = 0
        self.recycled = 0

    def _gen_of(self, buf) -> Optional[int]:
        with self._lock:
            return self._gens.get(id(buf))

    def acquire(self, nbytes: int) -> Loan:
        with self._lock:
            buf = None
            for i, b in enumerate(self._free):
                if len(b) >= nbytes:
                    buf = self._free.pop(i)
                    self.reused += 1
                    break
            if buf is None:
                # np.empty, not bytearray(n): bytearray zero-fills — a
                # hidden memset the recv_into overwrite makes pure waste
                buf = np.empty(max(int(nbytes), self.default_size),
                               dtype=np.uint8)
            gen = self._gens.setdefault(id(buf), 0)
            self.acquired += 1
            return Loan(self, buf, int(nbytes), gen)

    def release(self, loan: Loan):
        """Recycle the buffer: its generation advances, so stale views of
        this loan become typed violations rather than silent aliases."""
        if loan.detached:
            return
        with self._lock:
            bid = id(loan.buf)
            if self._gens.get(bid) != loan.gen:
                return                        # double release: already gone
            self._gens[bid] = loan.gen + 1
            self.recycled += 1
            if len(self._free) < self.max_free:
                self._free.append(loan.buf)
            else:
                self._gens.pop(bid, None)     # evicted for good

    def _detach(self, loan: Loan):
        with self._lock:
            if self._gens.get(id(loan.buf)) == loan.gen:
                self._gens.pop(id(loan.buf), None)

    def stats(self) -> dict:
        with self._lock:
            return {"acquired": self.acquired, "reused": self.reused,
                    "recycled": self.recycled, "free": len(self._free)}


def _recv_into_exact(sock, mv: memoryview, *, residue=None,
                     at_boundary: bool = False, idle_ok: bool = False,
                     stall_s: float = 0.0, on_stall=None):
    """``recv_into`` counterpart of ``_recv_exact``: fills ``mv`` in
    place (no staging buffer, no copy) with the same boundary/idle/EOF/
    stall semantics. ``residue`` is a bytearray of bytes a buffered reader
    already pulled; it is drained first."""
    need = len(mv)
    got = 0
    if residue:
        take = min(len(residue), need)
        mv[:take] = residue[:take]
        del residue[:take]
        got = take
    t_last = time.monotonic()
    stalled = False
    while got < need:
        try:
            n = sock.recv_into(mv[got:])
        except socket.timeout as e:
            if idle_ok and at_boundary and got == 0:
                return IDLE
            if _stalling(got or not at_boundary, t_last, stall_s):
                stalled = True
                continue
            raise PoolConnectionError("timed out waiting for peer") from e
        except OSError as e:
            raise PoolConnectionError(str(e)) from e
        if n == 0:
            if at_boundary and got == 0:
                return None
            raise WireError(f"peer closed mid-frame ({got}/{need} bytes)")
        got += n
        stalled = _stall_ended(stalled, t_last, on_stall)
        t_last = time.monotonic()
    return got


def recv_frame_pooled(sock: socket.socket, pool: BufferPool, *,
                      residue=None, idle_ok: bool = False,
                      stall_s: float = 0.0, on_stall=None):
    """v3 receive: the whole frame lands in ONE pooled buffer via
    ``recv_into`` and the body surfaces as a zero-copy memoryview into
    the loan. Returns ``(hdr, body, wire_bytes, loan)``, or None / IDLE
    with ``recv_frame_sized`` semantics. Header-parse failures inside an
    intact frame release the loan and raise soft ``WireError``s — the
    stream stays at a frame boundary."""
    head = bytearray(8)
    got = _recv_into_exact(sock, memoryview(head), residue=residue,
                           at_boundary=True, idle_ok=idle_ok,
                           stall_s=stall_s, on_stall=on_stall)
    if got is None or got is IDLE:
        return got
    total, hword = struct.unpack("<II", head)
    if total < 4 or total > MAX_FRAME:
        raise WireError(f"bad frame length {total}")
    binary = bool(hword & BIN_HDR_FLAG)
    hlen = hword & ~BIN_HDR_FLAG
    payload = total - 4
    loan = pool.acquire(payload)
    mv = loan.view()
    if payload:
        _recv_into_exact(sock, mv, residue=residue, stall_s=stall_s,
                         on_stall=on_stall)
    try:
        if hlen > payload:
            raise _soft_wire_error(
                f"header length {hlen} overruns frame ({total})")
        if binary:
            hdr = unpack_v3_header(mv[:hlen])
        else:
            # wire-copy: header bytes only — bodies stay in the loan
            hdr = json.loads(bytes(mv[:hlen]).decode())
            if not isinstance(hdr, dict):
                raise _soft_wire_error("frame header is not an object")
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        pool.release(loan)
        raise _soft_wire_error(f"bad frame header: {e}") from e
    except WireError:
        pool.release(loan)
        raise
    return hdr, mv[hlen:], total + 4, loan


class PooledIngest:
    """v3 buffered receive for the server side: one ``recv_into`` pulls a
    whole burst of pipelined frames into a single pooled buffer, and each
    frame's header and body surface as zero-copy views of that buffer.
    This collapses the 2-syscalls-per-frame pattern of head/body reads
    into ~2 per burst — what ``BufferedSocket`` does for v1/v2, but
    without its staging copies: the buffered bytes ARE the frame bodies.

    Safe because dispatch on a connection is sequential: a frame's region
    of the buffer is dead (its body consumed by the handler) by the time
    ``next_frame`` is called again, so the space is reclaimed in place
    with no release/acquire churn. The only bytes this reader ever copies
    are relocations of a *partial* frame stranded at the buffer tail when
    the kernel split a burst — drained via ``take_moved()`` so the server
    can account them honestly as ``bytes_copied``."""

    __slots__ = ("sock", "pool", "_loan", "_arr", "_mv", "_lo", "_hi",
                 "bytes_moved")

    def __init__(self, sock: socket.socket, pool: BufferPool,
                 residue: bytes = b"", bufsize: int = 1 << 18):
        self.sock = sock
        self.pool = pool
        self._loan = pool.acquire(max(int(bufsize), len(residue) + 8))
        self._arr = self._loan.buf
        self._mv = self._loan.view()
        self._lo = 0
        self._hi = len(residue)
        self.bytes_moved = 0
        if residue:
            # bytes a pre-v3 buffered reader pulled before the switch
            self._mv[:len(residue)] = residue

    def take_moved(self) -> int:
        """Relocation copies since the last call (straddled frames)."""
        n, self.bytes_moved = self.bytes_moved, 0
        return n

    def next_frame(self, *, idle_ok: bool = False):
        """``recv_frame_pooled`` contract: ``(hdr, body, wire_bytes,
        loan)`` — ``loan`` is None for in-buffer frames (this reader
        reclaims the space itself) and a dedicated loan for frames larger
        than the buffer (the caller releases it once the body is
        consumed). Returns None on clean EOF at a frame boundary, IDLE on
        a quiet idle tick (``idle_ok``). Header-parse failures inside an
        intact frame consume the frame and raise soft ``WireError``s."""
        while True:
            avail = self._hi - self._lo
            if avail >= 8:
                total, hword = _HEAD.unpack_from(self._mv, self._lo)
                if total < 4 or total > MAX_FRAME:
                    raise WireError(f"bad frame length {total}")
                if 4 + total > len(self._mv):
                    return self._oversized(total, hword)
                if avail >= 4 + total:
                    return self._parse(total, hword)
            got = self._fill(at_boundary=avail == 0, idle_ok=idle_ok)
            if got is None or got is IDLE:
                return got

    def _fill(self, *, at_boundary: bool, idle_ok: bool):
        """One ``recv_into`` against the free tail; True when bytes
        landed, None / IDLE with frame-boundary semantics otherwise."""
        if self._lo == self._hi:
            self._lo = self._hi = 0
        elif self._hi == len(self._mv):
            # partial frame stranded at the tail: relocate to the front
            # (the space below _lo holds only already-dispatched frames)
            n = self._hi - self._lo
            src = self._arr[self._lo:self._hi]
            self._arr[:n] = src.copy() if self._lo < n else src
            self.bytes_moved += n
            self._lo, self._hi = 0, n
        try:
            n = self.sock.recv_into(self._mv[self._hi:])
        except socket.timeout as e:
            if idle_ok and at_boundary:
                return IDLE
            raise PoolConnectionError("timed out waiting for peer") from e
        except OSError as e:
            raise PoolConnectionError(str(e)) from e
        if n == 0:
            if at_boundary:
                return None
            raise WireError(
                f"peer closed mid-frame ({self._hi - self._lo} buffered)")
        self._hi += n
        return True

    def _parse(self, total: int, hword: int):
        lo = self._lo
        self._lo = lo + 4 + total    # consume first: parse errors are soft
        binary = bool(hword & BIN_HDR_FLAG)
        hlen = hword & ~BIN_HDR_FLAG
        payload = total - 4
        if hlen > payload:
            raise _soft_wire_error(
                f"header length {hlen} overruns frame ({total})")
        hmv = self._mv[lo + 8:lo + 8 + hlen]
        body = self._mv[lo + 8 + hlen:lo + 4 + total]
        try:
            if binary:
                hdr = unpack_v3_header(hmv)
            else:
                # wire-copy: header bytes only — bodies stay in the buffer
                hdr = json.loads(bytes(hmv).decode())
                if not isinstance(hdr, dict):
                    raise _soft_wire_error("frame header is not an object")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise _soft_wire_error(f"bad frame header: {e}") from e
        return hdr, body, total + 4, None

    def _oversized(self, total: int, hword: int):
        """Frame larger than the ingest buffer: stage it in a dedicated
        loan (everything buffered so far is a prefix of this one frame)."""
        payload = total - 4
        loan = self.pool.acquire(payload)
        mv = loan.view()
        have = self._hi - (self._lo + 8)
        try:
            if have > 0:
                mv[:have] = self._mv[self._lo + 8:self._hi]
                self.bytes_moved += have
            self._lo = self._hi = 0
            _recv_into_exact(self.sock, mv[have:])
            binary = bool(hword & BIN_HDR_FLAG)
            hlen = hword & ~BIN_HDR_FLAG
            if hlen > payload:
                raise _soft_wire_error(
                    f"header length {hlen} overruns frame ({total})")
            if binary:
                hdr = unpack_v3_header(mv[:hlen])
            else:
                # wire-copy: header bytes only — bodies stay in the loan
                hdr = json.loads(bytes(mv[:hlen]).decode())
                if not isinstance(hdr, dict):
                    raise _soft_wire_error("frame header is not an object")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            self.pool.release(loan)
            raise _soft_wire_error(f"bad frame header: {e}") from e
        except BaseException:
            self.pool.release(loan)
            raise
        return hdr, mv[hlen:], total + 4, loan


# ---------------------------------------------------------------------------
# error table — ONE registry mapping typed exceptions <-> wire frames
# ---------------------------------------------------------------------------

# kind -> (encode(exc) -> extra fields, decode(hdr) -> exception). Only
# errors that carry fields beyond their message need an entry; every other
# PoolError subclass round-trips by class name automatically (the subclass
# walk below), so a new typed pool error is wire-transparent with zero
# registration anywhere.
_ERROR_CODECS: dict[str, tuple[Callable, Callable]] = {}


def register_error(kind: str, encode: Callable, decode: Callable):
    _ERROR_CODECS[kind] = (encode, decode)


def _pool_error_types() -> dict[str, type]:
    """Name -> class over the whole PoolError subclass tree (classes are
    discovered wherever they are defined — device, compress, protocol —
    the moment their module is imported)."""
    out = {"PoolError": PoolError}
    stack = [PoolError]
    while stack:
        cls = stack.pop()
        for sub in cls.__subclasses__():
            out.setdefault(sub.__name__, sub)
            stack.append(sub)
    return out


def error_to_frame(exc: BaseException) -> dict:
    kind = type(exc).__name__
    codec = _ERROR_CODECS.get(kind)
    if codec is not None:
        out = {"ok": False, "kind": kind,
               "error": str(exc) or kind}
        out.update(codec[0](exc))
        return out
    if not isinstance(exc, PoolError):
        kind = "PoolError"
    return {"ok": False, "kind": kind,
            "error": str(exc) or type(exc).__name__}


def frame_to_error(hdr: dict) -> BaseException:
    kind = hdr.get("kind", "PoolError")
    codec = _ERROR_CODECS.get(kind)
    if codec is not None:
        return codec[1](hdr)
    cls = _pool_error_types().get(kind, PoolError)
    return cls(hdr.get("error", "remote error"))


register_error(
    "InjectedCrash",
    lambda e: {"point": e.point, "occurrence": e.occurrence},
    lambda h: InjectedCrash(h.get("point", "?"), h.get("occurrence", 0)))


# ---------------------------------------------------------------------------
# timeout classes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Timeouts:
    """Per-op-class deadlines. ``control`` ops answer from directory
    state; ``data`` ops touch media; ``bulk`` ops move whole region
    images (region_export/import, blob_put, batch frames). ``keepalive``
    is the idle-ping cadence of a v2 channel (0 disables)."""

    control: float = 30.0
    data: float = 120.0
    bulk: float = 480.0
    keepalive: float = 15.0

    # modeled worst-case link bandwidth for deadline scaling: a bulk frame
    # gets its flat class deadline PLUS transfer time at this floor, so a
    # giant region_export / replicate_domain image can never outrun its
    # own future (the flat value remains the minimum — small bulk frames
    # see exactly the historical deadline)
    BULK_BW_FLOOR = 4 * (1 << 20)      # bytes/s

    @classmethod
    def resolve(cls, timeout=None) -> "Timeouts":
        """None -> class defaults; a float rescales every class around it
        (the ``make_pool(..., timeout=...)`` / ``pool_timeout`` knob); a
        Timeouts instance passes through."""
        if timeout is None:
            return cls()
        if isinstance(timeout, Timeouts):
            return timeout
        t = float(timeout)
        return cls(control=min(t, 30.0), data=t, bulk=max(t, 4 * t),
                   keepalive=min(15.0, max(0.5, t / 4)))

    def for_hdr(self, hdr: dict, nbytes: int = 0) -> float:
        """Deadline for one request. ``nbytes`` is the request body size;
        bulk-class deadlines additionally scale with the *payload* the op
        will move (the region image behind an export, every sub-region of
        a batch), floored at the flat class value — the fix for large
        migrations spuriously rejecting their own future."""
        op = hdr.get("op")
        if op == "nmp":
            spec = NMP_OPS.get(hdr.get("kind"))
            klass = spec.timeout if spec is not None else "data"
        else:
            spec = OPS.get(op)
            klass = spec.timeout if spec is not None else "data"
        base = getattr(self, klass)
        if klass != "bulk":
            return base
        est = int(nbytes)
        region = hdr.get("region")
        if isinstance(region, dict):
            # an export's payload is the reply image, not the request body
            est = max(est, int(region.get("nbytes") or 0))
        for sub in hdr.get("ops") or ():
            if isinstance(sub, dict) and isinstance(sub.get("region"), dict):
                est += int(sub["region"].get("nbytes") or 0)
        return base + est / self.BULK_BW_FLOOR

    def tick(self) -> float:
        """Reader-thread wakeup period: fine enough to honor per-request
        deadlines and the keepalive cadence."""
        base = 1.0
        if self.keepalive > 0:
            base = min(base, self.keepalive / 3.0)
        return max(0.05, min(base, self.control / 4.0))


# ---------------------------------------------------------------------------
# op registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OpSpec:
    """One wire op: name, timeout class, and the permission bits the
    server's dispatch enforces (readonly connections are denied
    ``mutating`` ops; ``--no-control-ops`` servers deny ``control``
    ones; ``tenant=False`` ops run before hello)."""

    name: str
    timeout: str = "data"        # control | data | bulk
    mutating: bool = False       # denied outright on readonly connections
    reopen_ok: bool = False      # alloc: idempotent reopen stays allowed
    control: bool = False        # node-wide; gated by --no-control-ops
    tenant: bool = True          # requires a hello'd tenant identity
    doc: str = ""


OPS: dict[str, OpSpec] = {s.name: s for s in (
    OpSpec("hello", "control", tenant=False,
           doc="tenant handshake + wire-version negotiation"),
    OpSpec("ping", "control", tenant=False,
           doc="keepalive no-op (idle connections are alive, not dead)"),
    OpSpec("close", "control", tenant=False, doc="clean hang-up"),
    OpSpec("read", "data", doc="raw bytes out of the cache"),
    OpSpec("write", "data", mutating=True, doc="raw bytes into the cache"),
    OpSpec("persist", "data", doc="flush/fence barrier (cannot corrupt)"),
    OpSpec("ensure", "data", control=True, doc="grow the device"),
    OpSpec("capacity", "control", doc="device capacity gauge"),
    OpSpec("crash", "control", control=True, doc="node power-cycle drill"),
    OpSpec("set-faults", "control", control=True,
           doc="arm/clear the node's fault schedule"),
    OpSpec("alloc", "data", mutating=True, reopen_ok=True,
           doc="allocate (or idempotently reopen) a region"),
    OpSpec("get", "control", doc="directory lookup of one region"),
    OpSpec("regions", "control", doc="directory listing of one domain"),
    OpSpec("domains", "control", doc="this tenant's domains on the node"),
    OpSpec("free", "data", mutating=True, doc="free a whole domain"),
    OpSpec("free-region", "data", mutating=True, doc="free one region"),
    OpSpec("metrics", "control",
           doc="tenant counters (scope=all is a control op)"),
    OpSpec("nmp", "data", doc="near-memory op (see NMP_OPS per kind)"),
    OpSpec("batch", "bulk",
           doc="N sub-ops, one frame, one reply (scatter-gather)"),
)}


# -- near-memory op table ----------------------------------------------------
# ``run`` executes the kind against an NmpQueue with canonical keyword
# operands — the ONE dispatch table behind the server's nmp handler, a
# local device's ``nmp_batch``, and batch execution. Adding an nmp kind
# means adding exactly one NmpSpec here.


def _run_gather(q, region, *, idx=None, **_):
    return q.gather(region, idx)


def _run_bag_gather(q, region, *, idx=None, combine="sum", **_):
    return q.bag_gather(region, idx, combine=combine)


def _run_undo_snapshot(q, region, *, idx=None, **_):
    return q.undo_snapshot(region, idx)


def _run_slot_headers(q, region, *, nslots=0, slot_bytes=0, hdr_bytes=0,
                      **_):
    return q.slot_headers(region, int(nslots), int(slot_bytes),
                          int(hdr_bytes))


def _run_row_update(q, region, *, idx=None, rows=None, point=None, **_):
    q.row_update(region, idx, rows, point=point)
    return None


def _run_scatter_add(q, region, *, idx=None, rows=None, point=None, **_):
    q.scatter_add(region, idx, rows, point=point)
    return None


def _run_undo_log_append(q, region, *, idx=None, rows=None, point=None,
                         log_region=None, step=0, slot_off=0, slot_bytes=0,
                         compress="zlib", **_):
    if log_region is None:
        raise WireError("undo_log_append needs log_region")
    return q.undo_log_append(
        region, log_region, step=int(step), slot_off=int(slot_off),
        slot_bytes=int(slot_bytes), idx=idx, new_rows=rows,
        compress=compress, apply_point=point or "mirror-apply")


def _run_slot_clear(q, region, *, slots=(), slot_bytes=0, point=None, **_):
    return {"cleared": q.slot_clear(region, slots, int(slot_bytes),
                                    point=point or "undo-gc")}


def _run_region_export(q, region, *, compress="zlib", **_):
    return q.region_export(region, compress=compress)


def _run_region_import(q, region, *, blob=None, point=None, **_):
    q.region_import(region, blob, point=point or "migrate-import")
    return None


def _run_blob_put(q, region, *, blob=None, compress="zlib", point=None,
                  **_):
    return {"stored": q.blob_put(region, blob, compress=compress,
                                 point=point or "dense-blob")}


@dataclass(frozen=True)
class NmpSpec:
    """One near-memory op kind: mutability (readonly gate), timeout
    class, whether the trailing request body is an opaque blob, and the
    executor used by every local dispatch path."""

    kind: str
    run: Callable
    mutating: bool = False
    timeout: str = "data"
    blob: bool = False           # trailing body bytes -> blob operand
    doc: str = ""


NMP_OPS: dict[str, NmpSpec] = {s.kind: s for s in (
    NmpSpec("gather", _run_gather, doc="rows[idx] -> host"),
    NmpSpec("bag_gather", _run_bag_gather,
            doc="pool-side bag reduction of rows[idx]"),
    NmpSpec("undo_snapshot", _run_undo_snapshot,
            doc="pre-update image -> host (round-trip capture path)"),
    NmpSpec("slot_headers", _run_slot_headers,
            doc="strided undo-ring header scan, one round trip"),
    NmpSpec("row_update", _run_row_update, mutating=True,
            doc="idempotent row apply"),
    NmpSpec("scatter_add", _run_scatter_add, mutating=True,
            doc="pool-side gradient accumulate"),
    NmpSpec("undo_log_append", _run_undo_log_append, mutating=True,
            doc="fused capture+log+COMMIT+apply inside the node"),
    NmpSpec("slot_clear", _run_slot_clear, mutating=True,
            doc="batched COMMIT-word clear (undo GC)"),
    NmpSpec("region_export", _run_region_export, timeout="bulk",
            doc="verbatim region image -> framed compressed blob"),
    NmpSpec("region_import", _run_region_import, mutating=True,
            timeout="bulk", blob=True,
            doc="land an exported image verbatim (migration/replica)"),
    NmpSpec("blob_put", _run_blob_put, mutating=True, timeout="bulk",
            blob=True, doc="opaque blob through the compression engine"),
)}


# ---------------------------------------------------------------------------
# wire v3 — struct-packed binary headers for the data-class ops
# ---------------------------------------------------------------------------
# Layout after the (BIN_HDR_FLAG-tagged) hdr_len word:
#
#     u16 code | u16 flags | u64 rid | op-specific tail
#
# Strings are u16-length-prefixed UTF-8; shapes are u8 ndim + i64 dims;
# regions are u64 off + u64 nbytes + dtype + shape. Every binary-header op
# has a V3Codec (packer/unpacker pair) registered in ``V3_CODECS`` under
# its OPS / NMP_OPS name.
# A header carrying fields outside the codec's fixed layout packs as JSON
# instead (same frame grammar, no flag bit), so the binary path can never
# drop information silently.

_BH = struct.Struct("<HHQ")          # code, flags, rid
_U64x2 = struct.Struct("<QQ")
_I64 = struct.Struct("<q")
_U16 = struct.Struct("<H")

_C_READ, _C_WRITE = 1, 2
_NMP_CODE_BASE = 16
_C_RESP_RAW, _C_RESP_ARRAY = 64, 65

# nmp header flag bits (the common ``flags`` word)
_F_IDX, _F_ROWS, _F_LOG, _F_POINT, _F_COMPRESS = 1, 2, 4, 8, 16

# integer nmp scalars, binary-coded by table index
_NMP_SCALAR_KEYS = ("step", "slot_off", "slot_bytes", "nslots", "hdr_bytes")


def _pk_str(out: bytearray, s: str):
    b = s.encode()
    out += _U16.pack(len(b))
    out += b


def _up_str(mv, pos: int):
    (n,) = _U16.unpack_from(mv, pos)
    pos += 2
    # wire-copy: header string field (a few bytes), never body data
    return bytes(mv[pos:pos + n]).decode(), pos + n


def _pk_shape(out: bytearray, shape):
    out.append(len(shape))
    for d in shape:
        out += _I64.pack(int(d))


def _up_shape(mv, pos: int):
    nd = mv[pos]
    pos += 1
    dims = []
    for _ in range(nd):
        (d,) = _I64.unpack_from(mv, pos)
        dims.append(int(d))
        pos += 8
    return dims, pos


def _pk_region(out: bytearray, ent: dict):
    out += _U64x2.pack(int(ent["off"]), int(ent["nbytes"]))
    _pk_str(out, str(ent["dtype"]))
    _pk_shape(out, ent["shape"])


def _up_region(mv, pos: int):
    off, nbytes = _U64x2.unpack_from(mv, pos)
    pos += 16
    dtype, pos = _up_str(mv, pos)
    shape, pos = _up_shape(mv, pos)
    return {"off": int(off), "nbytes": int(nbytes), "dtype": dtype,
            "shape": shape}, pos


def _pk_read(hdr: dict, out: bytearray) -> int:
    out += _U64x2.pack(int(hdr["off"]), int(hdr["nbytes"]))
    _pk_str(out, str(hdr.get("tag", "read")))
    return 0


def _up_read(mv, pos: int, flags: int) -> dict:
    off, nbytes = _U64x2.unpack_from(mv, pos)
    pos += 16
    tag, pos = _up_str(mv, pos)
    return {"op": "read", "off": int(off), "nbytes": int(nbytes),
            "tag": tag}


def _pk_write(hdr: dict, out: bytearray) -> int:
    out += _I64.pack(int(hdr["off"]))
    _pk_str(out, str(hdr.get("tag", "write")))
    return 0


def _up_write(mv, pos: int, flags: int) -> dict:
    (off,) = _I64.unpack_from(mv, pos)
    pos += 8
    tag, pos = _up_str(mv, pos)
    return {"op": "write", "off": int(off), "tag": tag}


def _pk_nmp(hdr: dict, out: bytearray) -> int:
    flags = 0
    if "idx_shape" in hdr:
        flags |= _F_IDX
    if hdr.get("rows_dtype"):
        flags |= _F_ROWS
    if hdr.get("log_region"):
        flags |= _F_LOG
    if hdr.get("point") is not None:
        flags |= _F_POINT
    if "compress" in hdr:
        flags |= _F_COMPRESS
    _pk_region(out, hdr["region"])
    if flags & _F_LOG:
        _pk_region(out, hdr["log_region"])
    if flags & _F_IDX:
        _pk_shape(out, hdr["idx_shape"])
    if flags & _F_ROWS:
        _pk_str(out, str(hdr["rows_dtype"]))
        _pk_shape(out, hdr["rows_shape"])
    _pk_str(out, str(hdr.get("combine", "sum")))
    if flags & _F_POINT:
        _pk_str(out, str(hdr["point"]))
    if flags & _F_COMPRESS:
        _pk_str(out, str(hdr["compress"]))
    scalars = [(i, int(hdr[k])) for i, k in enumerate(_NMP_SCALAR_KEYS)
               if k in hdr]
    out.append(len(scalars))
    for i, v in scalars:
        out.append(i)
        out += _I64.pack(v)
    return flags


def _mk_up_nmp(kind: str):
    def up(mv, pos: int, flags: int) -> dict:
        hdr = {"op": "nmp", "kind": kind}
        hdr["region"], pos = _up_region(mv, pos)
        if flags & _F_LOG:
            hdr["log_region"], pos = _up_region(mv, pos)
        if flags & _F_IDX:
            hdr["idx_shape"], pos = _up_shape(mv, pos)
        if flags & _F_ROWS:
            hdr["rows_dtype"], pos = _up_str(mv, pos)
            hdr["rows_shape"], pos = _up_shape(mv, pos)
        hdr["combine"], pos = _up_str(mv, pos)
        hdr["point"] = None
        if flags & _F_POINT:
            hdr["point"], pos = _up_str(mv, pos)
        if flags & _F_COMPRESS:
            hdr["compress"], pos = _up_str(mv, pos)
        nsc = mv[pos]
        pos += 1
        for _ in range(nsc):
            ki = mv[pos]
            pos += 1
            (v,) = _I64.unpack_from(mv, pos)
            pos += 8
            if ki < len(_NMP_SCALAR_KEYS):
                hdr[_NMP_SCALAR_KEYS[ki]] = int(v)
        return hdr
    return up


@dataclass(frozen=True)
class V3Codec:
    """One binary-header op: wire code, the exact header-key set the
    fixed layout represents (anything else falls back to JSON), and the
    packer/unpacker pair. ``pack(hdr, out)`` appends the op tail to
    ``out`` and returns the flags word; ``unpack(mv, pos, flags)``
    rebuilds the canonical dict header the dispatcher already speaks."""

    name: str
    code: int
    fields: frozenset
    pack: Callable
    unpack: Callable


_READ_FIELDS = frozenset({"op", "rid", "off", "nbytes", "tag"})
_WRITE_FIELDS = frozenset({"op", "rid", "off", "tag"})
_NMP_FIELDS = frozenset({"op", "rid", "kind", "region", "log_region",
                         "idx_shape", "rows_dtype", "rows_shape", "combine",
                         "point", "compress", *_NMP_SCALAR_KEYS})

# the data-class nmp kinds that get binary headers (slot_clear and the
# legacy round-trip capture kinds stay JSON — cold paths)
_V3_NMP_KINDS = ("gather", "bag_gather", "undo_log_append", "slot_headers",
                 "region_export", "region_import", "blob_put")

V3_CODECS: dict[str, V3Codec] = {c.name: c for c in (
    V3Codec("read", _C_READ, _READ_FIELDS, _pk_read, _up_read),
    V3Codec("write", _C_WRITE, _WRITE_FIELDS, _pk_write, _up_write),
    *(V3Codec(kind, _NMP_CODE_BASE + i, _NMP_FIELDS, _pk_nmp,
              _mk_up_nmp(kind))
      for i, kind in enumerate(_V3_NMP_KINDS)),
)}


def _up_resp_raw(mv, pos: int, flags: int) -> dict:
    return {"ok": True}


def _up_resp_array(mv, pos: int, flags: int) -> dict:
    dtype, pos = _up_str(mv, pos)
    shape, pos = _up_shape(mv, pos)
    return {"ok": True, "dtype": dtype, "shape": shape}


_V3_BY_CODE: dict[int, V3Codec] = {c.code: c for c in V3_CODECS.values()}
_V3_BY_CODE[_C_RESP_RAW] = V3Codec("__resp_raw", _C_RESP_RAW, frozenset(),
                                   lambda h, o: 0, _up_resp_raw)
_V3_BY_CODE[_C_RESP_ARRAY] = V3Codec("__resp_array", _C_RESP_ARRAY,
                                     frozenset(), lambda h, o: 0,
                                     _up_resp_array)


def pack_v3_header(hdr: dict) -> Optional[bytes]:
    """Request header dict -> struct-packed bytes, or None when the op
    has no codec / carries fields outside the fixed layout (the caller
    then falls back to a JSON header in the same frame grammar)."""
    op = hdr.get("op")
    codec = V3_CODECS.get(hdr.get("kind") if op == "nmp" else op)
    if codec is None or not (hdr.keys() <= codec.fields):
        return None
    out = bytearray(_BH.size)
    try:
        flags = codec.pack(hdr, out)
    except (KeyError, TypeError, ValueError, struct.error):
        return None                   # unrepresentable values: JSON it is
    _BH.pack_into(out, 0, codec.code, flags, int(hdr.get("rid", 0)))
    return bytes(out)      # wire-copy: packed header bytes, not body data


def pack_v3_reply_header(rh: dict) -> Optional[bytes]:
    """Success-reply header -> binary bytes. Raw acks and array results
    pack; stats / capacity / error replies return None and ride as JSON
    frames on the same connection."""
    if rh.get("ok") is not True or "rid" not in rh:
        return None
    extra = rh.keys() - {"ok", "rid"}
    if not extra:
        return _BH.pack(_C_RESP_RAW, 0, int(rh["rid"]))
    if extra <= {"shape", "dtype"} and rh.get("shape") is not None:
        out = bytearray(_BH.size)
        try:
            _pk_str(out, str(rh["dtype"]))
            _pk_shape(out, rh["shape"])
        except (TypeError, ValueError, struct.error):
            return None
        _BH.pack_into(out, 0, _C_RESP_ARRAY, 0, int(rh["rid"]))
        return bytes(out)  # wire-copy: packed header bytes, not body data
    return None


def _v3_header(hdr: dict) -> Optional[bytes]:
    if "op" in hdr:
        return pack_v3_header(hdr)
    return pack_v3_reply_header(hdr)


def unpack_v3_header(mv) -> dict:
    """Binary header bytes -> the canonical dict header (requests get
    their op/kind back, replies their ok/shape/dtype). Soft WireError on
    garbage — the enclosing frame was already fully consumed."""
    if len(mv) < _BH.size:
        raise _soft_wire_error(f"binary header too short ({len(mv)}B)")
    code, flags, rid = _BH.unpack_from(mv, 0)
    codec = _V3_BY_CODE.get(code)
    if codec is None:
        raise _soft_wire_error(f"unknown binary op code {code}")
    try:
        hdr = codec.unpack(mv, _BH.size, flags)
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        raise _soft_wire_error(
            f"bad binary {codec.name} header: {e}") from e
    hdr["rid"] = int(rid)
    return hdr


# ---------------------------------------------------------------------------
# batch frames (scatter-gather)
# ---------------------------------------------------------------------------


def pack_batch(items: list) -> tuple[dict, list]:
    """[(sub_hdr, sub_body), ...] -> one ``batch`` frame. The body is a
    scatter list of the callers' own buffers (sub-bodies may themselves
    be segment lists); the top-level header stays JSON — it's the sub
    regions that carry the bulk bytes."""
    hdrs, lens, parts = [], [], []
    for shdr, sbody in items:
        segs = _as_segment_list(sbody)
        hdrs.append(shdr)
        lens.append(sum(len(s) for s in segs))
        parts.extend(segs)
    return {"op": "batch", "ops": hdrs, "lens": lens}, parts


def unpack_batch(hdr: dict, body) -> list:
    """Split a batch frame body into per-sub-op slices. On a memoryview
    body (the pooled v3 receive path) the slices are zero-copy views."""
    ops, lens = hdr.get("ops"), hdr.get("lens")
    if not isinstance(ops, list) or not isinstance(lens, list) \
            or len(ops) != len(lens):
        raise _soft_wire_error("malformed batch frame")
    if sum(int(n) for n in lens) != len(body):
        raise _soft_wire_error(
            f"batch body {len(body)}B != declared {sum(lens)}B")
    out, pos = [], 0
    for shdr, n in zip(ops, lens, strict=True):
        if not isinstance(shdr, dict):
            raise _soft_wire_error("batch sub-header is not an object")
        out.append((shdr, body[pos:pos + int(n)]))
        pos += int(n)
    return out


def pack_batch_results(results: list) -> tuple[dict, list]:
    """[(sub_hdr, sub_body), ...] -> the batch reply frame (each sub_hdr
    is a normal ok/error reply header, each sub-body scattered unjoined)."""
    hdrs, lens, parts = [], [], []
    for rh, rbody in results:
        segs = _as_segment_list(rbody)
        hdrs.append(rh)
        lens.append(sum(len(s) for s in segs))
        parts.extend(segs)
    return {"results": hdrs, "lens": lens}, parts


def unpack_batch_results(hdr: dict, body) -> list:
    return unpack_batch({"op": "batch", "ops": hdr.get("results"),
                         "lens": hdr.get("lens")}, body)


# ---------------------------------------------------------------------------
# client channel
# ---------------------------------------------------------------------------


class PoolFuture:
    """One in-flight request. ``result()`` blocks for the reply and
    re-raises the op's typed error; a timed-out or failed future never
    poisons its channel."""

    __slots__ = ("op", "rid", "t0", "deadline", "_chan", "_done", "_evt",
                 "_value", "_error")

    def __init__(self, op: str, rid: int, timeout: float, chan=None):
        self.op = op
        self.rid = rid
        self._chan = chan
        self.t0 = time.monotonic()
        self.deadline = self.t0 + timeout
        # the Event is lazy: deep pipelines complete most futures before
        # anyone waits on them, and per-op Event construction + the
        # already-set wait() lock round-trip were the top client-side
        # costs in the depth-8 profile. Publication order (completer sets
        # _done then reads _evt; waiter publishes _evt then re-checks
        # _done) guarantees at least one side sees the other.
        self._done = False
        self._evt: Optional[threading.Event] = None
        self._value = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done

    def set_result(self, value):
        self._value = value
        self._done = True
        evt = self._evt
        if evt is not None:
            evt.set()

    def set_error(self, err: BaseException):
        self._error = err
        self._done = True
        evt = self._evt
        if evt is not None:
            evt.set()

    def result(self, timeout: Optional[float] = None):
        """(hdr, body) of the reply, or the op's typed exception."""
        if not self._done:
            # about to block: push any corked request frames (ours
            # included) onto the wire first
            if self._chan is not None:
                self._chan.flush()
            evt = self._evt
            if evt is None:
                evt = self._evt = threading.Event()
            wait = timeout if timeout is not None \
                else max(0.1, self.deadline - time.monotonic() + 5.0)
            if not self._done and not evt.wait(wait):
                raise PoolTimeoutError(
                    f"op {self.op!r} got no reply within {wait:.1f}s")
        if self._error is not None:
            raise self._error
        return self._value


class CompletedFuture:
    """PoolFuture-compatible wrapper for ops resolved synchronously
    (v1 strict mode, local devices)."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    @staticmethod
    def done() -> bool:
        return True

    def result(self, timeout: Optional[float] = None):
        return self._value


class MappedFuture:
    """Applies a decode step to a future's (hdr, body) when awaited —
    how RemotePool's async ops return typed results, not raw frames."""

    __slots__ = ("_fut", "_fn")

    def __init__(self, fut, fn: Callable):
        self._fut = fut
        self._fn = fn

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None):
        return self._fn(self._fut.result(timeout))


class PoolChannel:
    """One socket, many in-flight ops.

    Before negotiation (and on v1 peers) the channel runs the strict v1
    exchange: one op at a time under a lock, fence-on-desync after any
    transport failure. ``activate(WIRE_V2)`` starts the reader thread:
    from then on ``submit`` tags each request with a fresh ``rid``,
    returns a future, and the reader matches replies by tag — failures,
    timeouts and typed errors reject single futures while the stream
    keeps flowing. The reader doubles as the keepalive timer (idle
    ``ping`` frames) and the per-request deadline enforcer.
    """

    LAT_WINDOW = 8192          # per-op latency samples kept (histograms)
    FLUSH_BYTES = 1 << 16      # corked-send watermark (see submit/flush)

    def __init__(self, sock: socket.socket, addr: str,
                 timeouts: Optional[Timeouts] = None):
        self.sock = sock
        self._rsock = BufferedSocket(sock)   # all frame reads go through it
        self.addr = addr
        self.timeouts = timeouts or Timeouts()
        self.wire = WIRE_V1
        self.closed = False
        self.tx_bytes = 0
        self.rx_bytes = 0
        self.pings = 0
        self.timeouts_fired = 0
        self.late_drops = 0
        self.stalls = 0          # reply pauses past the reader tick ...
        self.stall_s_total = 0.0   # ... waited out, and their seconds
        self.stall_s_max = 0.0
        self.bytes_copied = 0    # body bytes memcpy'd at the frame boundary
        self.data_frames = 0     # frames carrying data-class op traffic
        self._pool: Optional[BufferPool] = None   # v3 recv buffers
        self._residue = bytearray()   # bytes BufferedSocket read past hello
        self._send_lock = threading.Lock()
        self._out_buf: list = []      # corked request frames (segments)
        self._out_bytes = 0
        self._strict_lock = threading.RLock()
        self._pending_lock = threading.Lock()
        self._pending: dict[int, PoolFuture] = {}
        self._next_rid = 1
        self._last_send = time.monotonic()
        self._close_cause: Optional[str] = None
        self._reader: Optional[threading.Thread] = None
        self._op_count: dict[str, int] = {}
        self._op_lat: dict[str, deque] = {}

    # -- lifecycle -----------------------------------------------------------
    def activate(self, wire: int):
        """Called once hello negotiation settled the protocol version."""
        self.wire = int(wire)
        if self.wire >= WIRE_V3 and self._pool is None:
            # v3 receives land straight in pooled buffers via recv_into;
            # hand any bytes the buffered reader pulled past the hello
            # reply over to the pooled reader as residue.
            self._pool = BufferPool()
            self._residue += self._rsock.take_buffer()
        if self.wire >= WIRE_V2 and self._reader is None:
            self.sock.settimeout(self.timeouts.tick())
            self._reader = threading.Thread(target=self._read_loop,
                                            daemon=True)
            self._reader.start()

    def close(self, cause: Optional[str] = None):
        """``cause`` marks a transport death (vs a deliberate user close):
        later ops on the channel then re-raise it as a connection error
        instead of a generic "device closed"."""
        if self.closed:
            return
        self.closed = True
        self._close_cause = cause
        self._fail_pending(PoolError("device closed"))
        try:
            self.sock.close()
        except OSError:
            pass

    def _closed_error(self) -> PoolError:
        if self._close_cause is not None:
            return PoolConnectionError(self._close_cause)
        return PoolError("device closed")

    # -- strict exchange (hello / auth / v1 peers) ---------------------------
    def exchange(self, hdr: dict, body=b""):
        """One synchronous request/response round trip. On a v1 channel
        this is THE request path and any transport failure fences the
        connection (no correlation ids: a late reply could alias the
        next request's response)."""
        nbody = sum(len(s) for s in _as_segment_list(body))
        with self._strict_lock:
            if self.closed:
                raise self._closed_error()
            self.flush()             # corked frames precede strict ops
            try:
                if self._reader is None:
                    # per-op timeout class even on the strict path
                    self.sock.settimeout(self.timeouts.for_hdr(hdr, nbody))
                self.tx_bytes += send_frame(self.sock, hdr, body)
                got = recv_frame_sized(self._rsock)
            except OSError as e:
                # e.g. settimeout on a partitioned/severed socket — map
                # to the typed connection error like every other
                # transport failure on the strict path
                err = PoolConnectionError(str(e))
                self.close(f"pool server at {self.addr}: {err}")
                raise err from e
            except PoolError as e:
                self.close(f"pool server at {self.addr}: {e}")
                raise
            if got is None:
                msg = (f"pool server at {self.addr} closed the connection "
                       f"(server restart mid-op?)")
                self.close(msg)
                raise PoolConnectionError(msg)
            rh, rbody, n = got
            self.rx_bytes += n
            if hdr.get("op") in DATA_OPS:
                # strict path joins the request and stages the reply —
                # both bodies cross the frame boundary by copy
                self.data_frames += 1
                self.bytes_copied += nbody + len(rbody)
        self._record(hdr.get("op", "?"), time.monotonic())
        if not rh.get("ok"):
            raise frame_to_error(rh)
        return rh, rbody

    # -- pipelined path ------------------------------------------------------
    def submit(self, hdr: dict, body=b"",
               timeout: Optional[float] = None) -> PoolFuture:
        """Fire one request; returns its future. On a v1 channel the op
        completes synchronously (depth-1 pipelining, same API). The body
        may be bytes-like, an ndarray, or a segment list — it is corked
        as the caller's own buffers, uncopied, until ``flush`` puts it on
        the wire via vectored ``sendmsg``."""
        if self.wire < WIRE_V2:
            return CompletedFuture(self.exchange(hdr, body))
        if self.closed:
            raise self._closed_error()
        segs = _as_segment_list(body)
        nbody = sum(len(s) for s in segs)
        t = timeout if timeout is not None else \
            self.timeouts.for_hdr(hdr, nbody)
        with self._pending_lock:
            rid = self._next_rid
            self._next_rid += 1
            fut = PoolFuture(hdr.get("op", "?"), rid, t, self)
            self._pending[rid] = fut
        try:
            frame, nwire = pack_frame_segments({**hdr, "rid": rid}, segs,
                                               wire=self.wire)
        except PoolError:
            with self._pending_lock:
                self._pending.pop(rid, None)
            raise
        if hdr.get("op") in DATA_OPS:
            self.data_frames += 1
            if self.wire < WIRE_V3:
                # v1/v2 peers take joined frames: the body is memcpy'd
                # into the join on flush
                self.bytes_copied += nbody
        # cork, don't send: frames accumulate while the caller is ahead of
        # the replies and go out as ONE vectored send when a future blocks
        # in result() (or at the flush watermark / the reader's idle tick).
        # Deep pipelines thus pay ~1 syscall + context switch per burst.
        with self._send_lock:
            self._out_buf.extend(frame)
            self._out_bytes += nwire
            self.tx_bytes += nwire
            flush_now = self._out_bytes >= self.FLUSH_BYTES
        if flush_now:
            self.flush()
        return fut

    def flush(self):
        """Put every corked request segment on the wire in one vectored
        ``sendmsg`` burst (v3) or one joined sendall (v2 — its peers
        predate scatter receive but the frames are byte-identical).
        Called by blocking futures, the flush watermark, the keepalive
        path, and the reader's idle tick — so a corked frame is never
        delayed past one tick. A send failure here mid-stream corrupts
        the outbound framing, the one client-side failure that still
        kills the whole connection; the error surfaces through the
        rejected futures rather than from flush() itself."""
        with self._send_lock:
            if not self._out_buf:
                return
            segs, self._out_buf = self._out_buf, []
            self._out_bytes = 0
            try:
                if self.wire >= WIRE_V3:
                    sendmsg_all(self.sock, segs)
                else:
                    # wire-copy: v2 join — the v3 path above stays vectored
                    self.sock.sendall(b"".join(segs))
                self._last_send = time.monotonic()
                return
            except OSError as e:
                err = e
        msg = f"pool server at {self.addr}: {err}"
        self._fail_pending(PoolConnectionError(msg))
        self.close(msg)

    def request(self, hdr: dict, body=b"",
                timeout: Optional[float] = None):
        return self.submit(hdr, body, timeout=timeout).result()

    def request_batch(self, items: list, timeout: Optional[float] = None):
        """Ship [(hdr, body), ...] as ONE scatter-gather frame; returns
        the per-sub-op list of (hdr, body) | typed exception, in order."""
        hdr, body = pack_batch(items)
        rh, rbody = self.request(hdr, body, timeout=timeout)
        out = []
        for shdr, sbody in unpack_batch_results(rh, rbody):
            out.append((shdr, sbody) if shdr.get("ok")
                       else frame_to_error(shdr))
        return out

    # -- reader thread -------------------------------------------------------
    def _read_loop(self):
        # a reply already begun may pause up to the data-class deadline;
        # while it does, this thread neither flushes, expires nor pings
        stall = self.timeouts.data
        while not self.closed:
            try:
                if self._pool is not None:
                    got = recv_frame_pooled(self.sock, self._pool,
                                            residue=self._residue,
                                            idle_ok=True, stall_s=stall,
                                            on_stall=self._record_stall)
                else:
                    got = recv_frame_sized(self._rsock, idle_ok=True,
                                           stall_s=stall,
                                           on_stall=self._record_stall)
            except (PoolError, OSError) as e:
                if not self.closed:
                    msg = f"pool server at {self.addr}: {e}"
                    self._fail_pending(PoolConnectionError(msg))
                    self.close(msg)
                return
            if got is IDLE:
                self.flush()         # bound corking delay to one tick
                self._expire_overdue()
                self._maybe_keepalive()
                continue
            if got is None:
                msg = (f"pool server at {self.addr} closed the connection "
                       f"(server restart mid-op?)")
                self._fail_pending(PoolConnectionError(msg))
                self.close(msg)
                return
            if self._pool is not None:
                rh, rbody, n, loan = got
            else:
                (rh, rbody, n), loan = got, None
            self.rx_bytes += n
            with self._pending_lock:
                fut = self._pending.pop(rh.get("rid"), None)
            if fut is None:
                if loan is not None:
                    loan.release()
                self.late_drops += 1     # expired/abandoned rid: drop
                continue
            if fut.op in DATA_OPS:
                self.data_frames += 1
                if loan is None:
                    # v1/v2 reply bodies arrive through the staging
                    # buffer — one copy per body byte
                    self.bytes_copied += len(rbody)
            if loan is not None:
                if rh.get("ok") and len(rbody):
                    # the caller's np.frombuffer views take the buffer
                    # for good; acks and error frames recycle theirs
                    loan.detach()
                else:
                    loan.release()
            self._record(fut.op, fut.t0)
            if rh.get("ok"):
                fut.set_result((rh, rbody))
            else:
                fut.set_error(frame_to_error(rh))

    def _record_stall(self, seconds: float):
        self.stalls += 1
        self.stall_s_total += seconds
        self.stall_s_max = max(self.stall_s_max, seconds)

    def _expire_overdue(self):
        now = time.monotonic()
        with self._pending_lock:
            dead = [rid for rid, f in self._pending.items()
                    if now > f.deadline]
            futs = [self._pending.pop(rid) for rid in dead]
        for f in futs:
            self.timeouts_fired += 1
            f.set_error(PoolTimeoutError(
                f"op {f.op!r} timed out after "
                f"{now - f.t0:.1f}s (class deadline); connection stays up"))

    def _maybe_keepalive(self):
        ka = self.timeouts.keepalive
        if ka <= 0:
            return
        with self._pending_lock:
            busy = bool(self._pending)
        if busy or time.monotonic() - self._last_send < ka:
            return
        try:
            self.submit({"op": "ping"})
            self.flush()
            self.pings += 1
        except PoolError:
            pass                         # reader will notice the close

    def _fail_pending(self, err: BaseException):
        with self._pending_lock:
            futs, self._pending = list(self._pending.values()), {}
        for f in futs:
            f.set_error(err)

    # -- observability -------------------------------------------------------
    def _record(self, op: str, t0: float):
        dt = time.monotonic() - t0
        self._op_count[op] = self._op_count.get(op, 0) + 1
        lat = self._op_lat.get(op)
        if lat is None:
            lat = self._op_lat[op] = deque(maxlen=self.LAT_WINDOW)
        lat.append(dt)

    def latency_stats(self) -> dict:
        """Per-op latency percentiles (seconds) over the sample window —
        the bench's per-op histogram source."""
        out = {}
        for op, lat in self._op_lat.items():
            xs = sorted(lat)
            if not xs:
                continue
            n = len(xs)
            out[op] = {
                "count": self._op_count.get(op, n),
                "p50_s": xs[n // 2],
                "p95_s": xs[min(n - 1, int(n * 0.95))],
                "p99_s": xs[min(n - 1, int(n * 0.99))],
                "max_s": xs[-1],
                "samples": n,
            }
        return out

    def stats(self) -> dict:
        out = {"wire": self.wire, "tx_bytes": self.tx_bytes,
               "rx_bytes": self.rx_bytes, "pings": self.pings,
               "timeouts": self.timeouts_fired,
               "late_drops": self.late_drops,
               "stalls": self.stalls, "stall_s_total": self.stall_s_total,
               "stall_s_max": self.stall_s_max,
               "bytes_copied": self.bytes_copied,
               "data_frames": self.data_frames}
        if self._pool is not None:
            out["recv_pool"] = self._pool.stats()
        return out
