"""RemotePool: the client side of the memory-node wire protocol
(counterpart of ``repro.pool.remote``).

A ``RemotePool`` is a ``PoolDevice`` whose cache, media, allocator directory
and near-memory logic all live in another process
(``repro_torch.pool.server``), reached over a Unix or TCP socket. Several
trainer processes share one memory node, and the node, with every persisted
byte, survives any trainer's death (``kill -9`` included).

The wire format, the op table, the error mapping and the per-op timeout
classes are defined in ``repro_torch.pool.protocol``, byte for byte the JAX
package's, so this client talks to either package's server. On top of the
channel this module adds the PoolDevice-shaped client:

  * every connection negotiates a wire version at ``hello``; against a v2
    or v3 server it runs pipelined (many in-flight tagged requests, shared
    by any number of threads);
  * ``read_async`` / ``write_async`` / ``nmp_batch`` / ``read_batch`` are
    the pipelined and scatter-gather forms;
  * a failed op (typed pool error, per-op timeout, torn frame body)
    rejects only itself; only broken framing closes the socket;
  * a read or write larger than ``chunk_bytes()`` (a sixteenth of
    ``protocol.MAX_FRAME``) travels as several frames of the same format,
    pipelined a few at a time: a full-width mirror (2.56 GB for dlrm-rm1)
    exceeds the 1 GiB frame cap that both ends enforce.

Every connection must ``hello`` first, naming its tenant (and optionally a
byte quota). All later ops run under that tenant's namespace, quota and
metrics; the server checks raw offsets against the tenant's owned ranges.
"""
from __future__ import annotations

import dataclasses
import hmac
import os
import socket
from typing import Optional

import numpy as np

from repro_torch.pool import protocol
from repro_torch.pool.device import PoolDevice, PoolError
from repro_torch.pool.faults import FaultSchedule
from repro_torch.pool.metrics import PoolMetrics
# the protocol module is the registry of record; these names are re-exported
# so that callers of either package import them from the same place
from repro_torch.pool.protocol import (  # noqa: F401  (re-exported)
    MAX_FRAME, NMP_OPS, OPS, WIRE_V1, WIRE_V2, WIRE_V3, MappedFuture,
    PoolChannel, PoolConnectionError, PoolTimeoutError, Timeouts, WireError,
    CompletedFuture, _byteview, _recv_exact, error_to_frame, format_addr,
    frame_to_error, pack_batch, parse_addr, recv_frame, register_error,
    send_frame, tune_socket, unpack_batch_results, wire_from_env)

# the default "data" deadline (ops carry per-class deadlines,
# ``protocol.Timeouts``)
DEFAULT_TIMEOUT = Timeouts().data

# frames of a split read or write kept in flight at once
SPLIT_WINDOW = 4


def chunk_bytes() -> int:
    """Largest read or write that travels as one frame: a sixteenth of the
    frame cap, read at call time (so a test that shrinks the cap shrinks
    the chunks with it)."""
    return max(1, protocol.MAX_FRAME // 16)


def _spans(off: int, nbytes: int) -> list:
    step = chunk_bytes()
    return [(o, min(step, off + nbytes - o))
            for o in range(off, off + nbytes, step)]


class PoolAuthError(PoolError):
    """The tcp handshake failed the server's shared-secret check (wrong or
    missing ``--pool-secret`` / ``REPRO_POOL_SECRET``). Carries the server's
    ``challenge`` nonce when one was issued (the client answers it with
    HMAC-SHA256(secret, challenge:tenant)). Unix sockets are exempt — the
    filesystem already gates them."""

    def __init__(self, msg: str, challenge: str = ""):
        super().__init__(msg)
        self.challenge = challenge


register_error(
    "PoolAuthError",
    lambda e: {"challenge": e.challenge} if e.challenge else {},
    lambda h: PoolAuthError(h.get("error", "pool auth failed"),
                            challenge=h.get("challenge", "")))


def auth_proof(secret: str, challenge: str, tenant: str) -> str:
    """The handshake proof: HMAC-SHA256 over the server nonce and the
    tenant name, so a captured proof neither replays on a later connection
    nor transplants onto another tenant."""
    return hmac.new(secret.encode(),
                    f"{challenge}:{tenant}".encode(), "sha256").hexdigest()


def _as_segment(data):
    """One outbound body buffer, uncopied: bytes-likes pass through,
    arrays become flat byte views (contiguity materialized only when the
    array actually is strided)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return data
    return memoryview(np.ascontiguousarray(data)).cast("B")


def _region_hdr(region) -> dict:
    return {"off": region.off, "nbytes": region.nbytes,
            "dtype": region.dtype, "shape": list(region.shape)}


def encode_nmp(kind: str, region, idx=None, rows=None, blob=None,
               combine: str = "sum", point: Optional[str] = None,
               log_region=None, **extra):
    """One nmp call -> (hdr, body segments) — the wire form shared by the
    single-op path and scatter-gather batch frames. The body is a scatter
    list of views over the caller's own idx/rows/blob buffers; nothing is
    joined client-side (the channel ships the segments vectored)."""
    hdr = {"op": "nmp", "kind": kind, "combine": combine, "point": point,
           "region": _region_hdr(region)}
    body = []
    if idx is not None:
        idx = np.ascontiguousarray(np.asarray(idx), dtype=np.int64)
        hdr["idx_shape"] = list(idx.shape)
        body.append(_as_segment(idx))
    if rows is not None:
        rows = np.ascontiguousarray(rows)
        hdr["rows_dtype"] = str(rows.dtype)
        hdr["rows_shape"] = list(rows.shape)
        body.append(_as_segment(rows))
    if blob is not None:
        body.append(_as_segment(blob))
    if log_region is not None:
        hdr["log_region"] = _region_hdr(log_region)
    hdr.update(extra)
    return hdr, body


def decode_nmp(rh: dict, rbody):
    """Reply frame -> stats dict | result array | None. The array is a
    zero-copy view over the reply body — on a v3 channel that is the
    pooled recv buffer itself (detached to the caller, never recycled)."""
    if "stats" in rh:
        return rh["stats"]
    if rh.get("shape") is None:
        return None
    return np.frombuffer(rbody, dtype=rh["dtype"]).reshape(rh["shape"])


# ---------------------------------------------------------------------------
# client device
# ---------------------------------------------------------------------------


class RemotePool(PoolDevice):
    """PoolDevice backed by a pool-server process.

    ``view`` returns a *local copy* of the server cache (read-mostly; the ops
    that mutate views in-process — the nmp layer — execute server-side
    instead), ``mark_dirty`` is a no-op (the server tracks dirt on write),
    and ``metrics`` is a freshly-fetched snapshot of this tenant's
    server-side counters.

    ``timeout`` accepts a float (rescales every timeout class around it —
    the historical knob) or a ``protocol.Timeouts``; ``wire`` pins the
    maximum protocol generation to offer (default: v3, or
    ``REPRO_POOL_WIRE``).
    """

    backend = "remote"
    remote = True

    def __init__(self, addr: str, tenant: str = "default", quota: int = 0,
                 timeout=None, secret: Optional[str] = None,
                 readonly: bool = False, wire: Optional[int] = None):
        self.addr = addr
        self.tenant = tenant
        self.readonly = bool(readonly)
        self._faults: Optional[FaultSchedule] = None
        self._timeouts = Timeouts.resolve(timeout)
        # the shared secret never lands in POOL.json: a reconnect
        # (recovery) picks it up from the environment again
        self._secret = secret or os.environ.get("REPRO_POOL_SECRET", "")
        wire_max = int(wire) if wire is not None else wire_from_env()
        kind, target = parse_addr(addr)
        try:
            if kind == "unix":
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            else:
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.settimeout(self._timeouts.data)
            tune_socket(sock)
            sock.connect(target)
        except OSError as e:
            raise PoolConnectionError(
                f"cannot reach pool server at {addr}: {e}") from e
        self._sock = sock
        self._chan = PoolChannel(sock, addr, self._timeouts)
        hello = {"op": "hello", "tenant": tenant, "quota": int(quota),
                 "wire": wire_max}
        if self.readonly:
            # a serving connection: the server denies every mutating op on
            # this connection with a typed TenantIsolationError
            hello["readonly"] = True
        try:
            hdr, _ = self._chan.exchange(hello)
        except PoolAuthError as e:
            # challenge round: answer the nonce with the shared-secret HMAC
            if not e.challenge or not self._secret:
                raise
            hdr, _ = self._chan.exchange({
                **hello, "challenge": e.challenge,
                "auth": auth_proof(self._secret, e.challenge, tenant)})
        self._capacity = int(hdr["capacity"])
        self.device_name = hdr.get("device", "remote")
        self.frames_split = 0      # frames sent by split reads and writes
        self.wire = int(hdr.get("wire", WIRE_V1))
        self._chan.activate(self.wire)

    # -- plumbing ------------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._chan.closed

    @closed.setter
    def closed(self, value: bool):
        if value:                      # tests sever the link this way
            self._chan.close()

    def _request(self, hdr: dict, body: bytes = b""):
        """One op, one result — every blocking method funnels through here
        (tests count round trips by intercepting this seam)."""
        return self._chan.request(hdr, body)

    def _request_batch(self, items: list, raise_errors: bool = True) -> list:
        """[(hdr, body), ...] -> per-sub-op [(hdr, body) | exception] via
        ONE scatter-gather frame (a single round trip on the wire and a
        single call through the ``_request`` seam)."""
        hdr, body = pack_batch(items)
        rh, rbody = self._request(hdr, body)
        out = []
        for shdr, sbody in unpack_batch_results(rh, rbody):
            if shdr.get("ok"):
                out.append((shdr, sbody))
                continue
            err = frame_to_error(shdr)
            if raise_errors:
                raise err
            out.append(err)
        return out

    # -- PoolDevice surface ----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._capacity

    def ensure(self, nbytes: int):
        rh, _ = self._request({"op": "ensure", "nbytes": int(nbytes)})
        self._capacity = int(rh["capacity"])

    def refresh_capacity(self) -> int:
        """Re-read the device capacity gauge from the node. ``capacity`` is
        otherwise a cached value piggybacked on hello/ensure/alloc replies —
        stale when ANOTHER tenant grows the shared device."""
        rh, _ = self._request({"op": "capacity"})
        self._capacity = int(rh["capacity"])
        return self._capacity

    def read(self, off: int, nbytes: int, tag: str = "read") -> np.ndarray:
        if nbytes > chunk_bytes():
            return self._read_split(off, nbytes, tag)
        _, body = self._request({"op": "read", "off": int(off),
                                 "nbytes": int(nbytes), "tag": tag})
        return np.frombuffer(body, dtype=np.uint8)   # read-only by nature

    def _read_split(self, off: int, nbytes: int, tag: str) -> np.ndarray:
        """One read as several frames, ``SPLIT_WINDOW`` in flight, each
        reply copied into one output array as it lands."""
        off, nbytes = int(off), int(nbytes)
        out = np.empty(nbytes, dtype=np.uint8)
        inflight = []

        def land(item):
            o, n, fut = item
            _, body = fut.result()
            if len(body) != n:
                raise WireError(f"split read at {o}: {len(body)} of {n} "
                                "bytes")
            out[o - off:o - off + n] = np.frombuffer(body, dtype=np.uint8)

        for o, n in _spans(off, nbytes):
            inflight.append((o, n, self._chan.submit(
                {"op": "read", "off": o, "nbytes": n, "tag": tag})))
            self.frames_split += 1
            if len(inflight) >= SPLIT_WINDOW:
                land(inflight.pop(0))
        for item in inflight:
            land(item)
        return out

    def read_async(self, off: int, nbytes: int, tag: str = "read"):
        """Pipelined read: returns a future whose ``result()`` is the row
        bytes. Any number may be in flight on one connection (v2); against
        a v1 server this degrades to a completed depth-1 op. A read larger
        than one frame completes before this returns."""
        if nbytes > chunk_bytes():
            return CompletedFuture(self._read_split(off, nbytes, tag))
        fut = self._chan.submit({"op": "read", "off": int(off),
                                 "nbytes": int(nbytes), "tag": tag})
        return MappedFuture(fut, lambda r: np.frombuffer(r[1],
                                                         dtype=np.uint8))

    def read_batch(self, reqs, tag: str = "read") -> list:
        """[(off, nbytes), ...] -> [bytes-like, ...] in ONE scatter-gather
        frame: one link round trip for N region reads. On a v3 channel the
        results are zero-copy views into the frame's recv buffer."""
        if not reqs:
            return []
        items = [({"op": "read", "off": int(o), "nbytes": int(n),
                   "tag": tag}, b"") for o, n in reqs]
        return [sb for _, sb in self._request_batch(items)]

    def view(self, off: int, nbytes: int) -> np.ndarray:
        # a writable LOCAL copy: mutations do not reach the server (remote
        # mutation goes through write() and the nmp ops)
        if nbytes > chunk_bytes():
            return self._read_split(off, nbytes, "view")
        _, body = self._request({"op": "read", "off": int(off),
                                 "nbytes": int(nbytes), "tag": "view"})
        return np.frombuffer(body, dtype=np.uint8).copy()

    def write(self, off: int, data, tag: str = "write"):
        seg = _byteview(_as_segment(data))
        if len(seg) > chunk_bytes():
            self._write_split(off, seg, tag)
            return
        self._request({"op": "write", "off": int(off), "tag": tag}, seg)

    def _write_split(self, off: int, seg, tag: str):
        """One write as several frames, ``SPLIT_WINDOW`` in flight; each
        frame's body is a view of the caller's buffer."""
        off = int(off)
        view = memoryview(seg)
        inflight = []
        for o, n in _spans(off, len(view)):
            inflight.append(self._chan.submit(
                {"op": "write", "off": o, "tag": tag},
                view[o - off:o - off + n]))
            self.frames_split += 1
            if len(inflight) >= SPLIT_WINDOW:
                inflight.pop(0).result()
        for fut in inflight:
            fut.result()

    def write_async(self, off: int, data, tag: str = "write"):
        seg = _byteview(_as_segment(data))
        if len(seg) > chunk_bytes():
            self._write_split(off, seg, tag)
            return CompletedFuture(None)
        fut = self._chan.submit({"op": "write", "off": int(off),
                                 "tag": tag}, seg)
        return MappedFuture(fut, lambda r: None)

    def mark_dirty(self, off: int, nbytes: int):
        pass                       # the server marks dirt on its own writes

    def persist(self, off: Optional[int] = None,
                nbytes: Optional[int] = None, point: str = "persist"):
        self._request({"op": "persist", "off": off, "nbytes": nbytes,
                       "point": point})

    def crash(self):
        """Ask the server to power-cycle the device (volatile cache dropped,
        durable media reloaded) — the memory-node power-loss drill."""
        self._request({"op": "crash"})

    def ping(self):
        """Round-trip no-op (liveness probe; also what the channel sends
        on its own when idle)."""
        self._request({"op": "ping"})

    def close(self):
        if not self._chan.closed:
            try:
                send_frame(self._sock, {"op": "close"})
            except PoolError:
                pass
            self._chan.close()

    # -- faults (server-side schedule, set over the wire) ---------------------
    @property
    def faults(self) -> Optional[FaultSchedule]:
        return self._faults

    @faults.setter
    def faults(self, schedule: Optional[FaultSchedule]):
        events = ([dataclasses.asdict(e) for e in schedule.events]
                  if schedule is not None else None)
        self._request({"op": "set-faults", "events": events})
        self._faults = schedule

    # -- metrics ---------------------------------------------------------------
    @property
    def metrics(self) -> PoolMetrics:
        """This tenant's server-side counters, as a fresh snapshot object."""
        rh, _ = self._request({"op": "metrics"})
        return PoolMetrics.from_snapshot(rh["snapshot"])

    def metrics_snapshot(self, scope: str = "tenant") -> dict:
        rh, _ = self._request({"op": "metrics", "scope": scope})
        return rh.get("tenants") if scope == "all" else rh["snapshot"]

    def reset_metrics(self):
        self._request({"op": "metrics", "reset": True})

    def latency_stats(self) -> dict:
        """Client-observed per-op latency percentiles (the bench's
        histogram source)."""
        return self._chan.latency_stats()

    def wire_stats(self) -> dict:
        """Channel counters: negotiated version, tx/rx bytes, keepalive
        pings, per-request timeouts, late-reply drops."""
        return self._chan.stats()

    # -- allocator proxy (PoolAllocator routes through these) ------------------
    def alloc_region(self, domain: str, name: str, shape, dtype: str,
                     point: str = "superblock") -> dict:
        rh, _ = self._request({"op": "alloc", "domain": domain, "name": name,
                               "shape": [int(s) for s in shape],
                               "dtype": dtype, "point": point})
        self._capacity = int(rh.get("capacity", self._capacity))
        return rh["region"]

    def alloc_regions(self, domain: str, specs, point: str = "superblock") \
            -> list:
        """[(name, shape, dtype), ...] -> region entries, allocated in ONE
        batch frame (the migration/replica copy path's alloc burst)."""
        if not specs:
            return []
        items = [({"op": "alloc", "domain": domain, "name": name,
                   "shape": [int(s) for s in shape], "dtype": dtype,
                   "point": point}, b"") for name, shape, dtype in specs]
        ents = []
        for rh, _ in self._request_batch(items):
            self._capacity = int(rh.get("capacity", self._capacity))
            ents.append(rh["region"])
        return ents

    def get_region(self, domain: str, name: str) -> Optional[dict]:
        rh, _ = self._request({"op": "get", "domain": domain, "name": name})
        return rh["region"]

    def list_regions(self, domain: str) -> dict:
        rh, _ = self._request({"op": "regions", "domain": domain})
        return rh["regions"]

    def list_remote_domains(self) -> list:
        """This tenant's domains on the node — the open-time sweep's and the
        rebalance policy's view of what actually lives where."""
        rh, _ = self._request({"op": "domains"})
        return list(rh["domains"])

    def free_remote_domain(self, domain: str,
                           point: str = "superblock") -> bool:
        rh, _ = self._request({"op": "free", "domain": domain,
                               "point": point})
        return bool(rh["freed"])

    def free_remote_region(self, domain: str, name: str,
                           point: str = "superblock") -> bool:
        rh, _ = self._request({"op": "free-region", "domain": domain,
                               "name": name, "point": point})
        return bool(rh["freed"])

    # -- near-memory ops --------------------------------------------------------
    def nmp(self, kind: str, region, idx=None, rows=None, blob=None,
            combine: str = "sum", point: Optional[str] = None,
            log_region=None, **extra):
        """Ship one near-memory op to the server; returns the result array
        (gather / bag_gather / undo_snapshot / slot_headers), a stats dict
        (undo_log_append / blob_put), or None (row_update / scatter_add).
        ``log_region`` names a second owned region (the undo-log ring) for
        the fused capture op; scalar op parameters ride in ``extra``."""
        hdr, body = encode_nmp(kind, region, idx=idx, rows=rows, blob=blob,
                               combine=combine, point=point,
                               log_region=log_region, **extra)
        rh, rbody = self._request(hdr, body)
        return decode_nmp(rh, rbody)

    def nmp_batch(self, calls) -> list:
        """[(kind, region, kwargs), ...] near-memory ops in ONE
        scatter-gather frame — a whole replica refresh or migration copy
        costs one link round trip instead of one per region."""
        if not calls:
            return []
        items = [encode_nmp(kind, region, **kw) for kind, region, kw in calls]
        return [decode_nmp(rh, rb)
                for rh, rb in self._request_batch(items)]
