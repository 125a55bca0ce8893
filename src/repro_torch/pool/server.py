"""Standalone pool-server process, the emulated CXL memory node
(counterpart of ``repro.pool.server``).

Owns ONE backing device (``DramPool`` or ``PmemPool``) with its allocator
directory and near-memory logic, and serves the wire protocol of
``repro_torch.pool.protocol`` (the op registry; see its docstring for the
reference table) to any number of trainer processes over a Unix or TCP
socket. The frames are the JAX package's, so clients of either package are
served. Connections negotiate a wire generation at hello: v2 peers get
tagged frames (the connection's reader decodes and dispatches while
replies drain out of a per-connection writer queue), scatter-gather
``batch`` frames and keepalive ``ping``s; v3 peers also run the zero-copy
data path (binary headers, pooled ``recv_into`` request buffers, reply
bodies sent as device-memory views through vectored ``sendmsg``); v1 peers
keep the strict request/response protocol. A trainer's death (``kill -9``
included) costs the node nothing; the node's death loses only unpersisted
cache, like a power-cycled module, and a pmem-backed node recovers its
media image on restart.

Multi-tenancy: each connection ``hello``s with a tenant name (and optional
byte quota). The server keeps one tenant-scoped ``PoolAllocator`` and one
``PoolMetrics`` per tenant:

  * namespaces: tenant A's ``undo-log`` and tenant B's ``undo-log`` are
    different domains in the shared directory (``A::undo-log``);
  * quotas: allocations beyond the tenant's byte budget raise
    ``QuotaExceededError``;
  * isolation: every raw read/write/persist/nmp range must fall inside a
    region the tenant owns, else ``TenantIsolationError``. The control
    plane (crash / set-faults / ensure / all-tenants metrics) is node-wide
    and can be denied to tenants with ``control_ops=False`` (CLI
    ``--no-control-ops``);
  * read-only connections (hello ``readonly``): every mutating op is
    denied, an ``alloc`` only reopens an identical region;
  * attribution: the device traffic recorded while serving a request lands
    in that tenant's ``PoolMetrics`` (``metrics`` op; ``scope=all`` for
    the operator view).

``bag_gather`` runs on the region's flat (rows, d) view: its ids are flat
row ids, as the JAX package's node reads them, so stacked tables are never
offset twice.

Fault injection stays a memory-node property: schedules set with the
``set-faults`` control op arm the device's persist barriers; an
``InjectedCrash`` goes back to the requesting client as a typed error while
the node keeps serving.

    PYTHONPATH=src python -m repro_torch.pool.server \
        --addr unix:/tmp/pool.sock --backend pmem --path /tmp/pool.img

It prints ``pool-server listening on <addr> ...`` once it accepts
connections, and shuts down on SIGTERM or SIGINT.
"""
from __future__ import annotations

import argparse
import contextlib
import hmac
import os
import queue
import secrets as pysecrets
import signal
import socket
import sys
import threading
from typing import Optional

import numpy as np

from repro_torch.pool.allocator import PoolAllocator, Region
from repro_torch.pool.device import (DramPool, PmemPool, PoolDevice,
                                     PoolError, TenantIsolationError)
from repro_torch.pool.faults import FaultEvent, FaultSchedule, InjectedCrash
from repro_torch.pool.metrics import PoolMetrics
from repro_torch.pool.nmp import NmpQueue
from repro_torch.pool.protocol import (DATA_OPS, NMP_OPS, OPS, WIRE_V1,
                                       WIRE_V2, WIRE_V3, BufferedSocket,
                                       BufferPool, PooledIngest, WireError,
                                       _as_segment_list, error_to_frame,
                                       format_addr, pack_batch_results,
                                       pack_frame_segments, parse_addr,
                                       recv_frame, send_frame, sendmsg_all,
                                       tune_socket, unpack_batch,
                                       wire_from_env)
from repro_torch.pool.remote import PoolAuthError, auth_proof


class Tenant:
    def __init__(self, name: str, device: PoolDevice, quota: int):
        self.name = name
        self.quota = int(quota)
        self.metrics = PoolMetrics(device_name=device.profile.name)
        self.alloc = PoolAllocator(device, tenant=name, quota=quota)
        self.ranges = None      # owned-ranges cache; None = recompute

    def owned_ranges(self):
        # the server is the only directory writer and invalidates this on
        # alloc/free/crash, so the hot read/write/nmp path skips re-parsing
        # the superblock per request
        if self.ranges is None:
            self.ranges = self.alloc.owned_ranges()
        return self.ranges


class PoolServer:
    def __init__(self, device: PoolDevice, addr: str, default_quota: int = 0,
                 conn_timeout: Optional[float] = 600.0,
                 control_ops: bool = True, secret: str = "",
                 wire: Optional[int] = None):
        self.device = device
        self.default_quota = int(default_quota)
        self.conn_timeout = conn_timeout
        self.control_ops = control_ops
        self.secret = secret
        # highest protocol generation offered at hello (REPRO_POOL_WIRE
        # pins it)
        self.wire_max = int(wire) if wire is not None else wire_from_env()
        self.tenants: dict[str, Tenant] = {}
        self._lock = threading.RLock()       # serialises all device work
        # zero-copy read replies are live views of device cache while they
        # sit in a reply queue; mutating ops drain them first (view gate)
        self._views_cv = threading.Condition()
        self._views_out = 0
        self._nmp = NmpQueue(device)
        self._stop = threading.Event()
        self._conns: set = set()
        kind, target = parse_addr(addr)
        self._kind = kind
        if kind == "unix":
            with contextlib.suppress(OSError):
                os.unlink(target)
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
        else:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
        self._listener.bind(target)
        self._listener.listen(32)
        if kind == "tcp":
            target = self._listener.getsockname()[:2]   # resolve port 0
        self.addr = format_addr(kind, target)

    # -- lifecycle ------------------------------------------------------------
    def serve_forever(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                break                       # listener closed by shutdown()
            tune_socket(conn)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def start(self) -> "PoolServer":
        """Run the accept loop on a daemon thread (in-process servers for
        tests and demos); returns self."""
        threading.Thread(target=self.serve_forever, daemon=True).start()
        return self

    def shutdown(self, close_device: bool = False):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if close_device:
            self.device.close()

    # -- view gate --------------------------------------------------------------
    # Zero-copy read replies carry views of the live device cache until the
    # writer puts them on the wire. A mutating op dispatched while such a
    # view is queued (on ANY connection) could change the bytes under it,
    # so mutators wait for the in-flight view count to reach zero first.
    def _views_add(self, n: int):
        if n:
            with self._views_cv:
                self._views_out += n

    def _views_done(self, n: int):
        if n:
            with self._views_cv:
                self._views_out -= n
                self._views_cv.notify_all()

    def _views_drain(self):
        with self._views_cv:
            if self._views_out:
                # bounded wait: a writer that died mid-send must not wedge
                # every mutator forever
                self._views_cv.wait_for(lambda: self._views_out == 0,
                                        timeout=5.0)

    def _mutates(self, op, hdr: dict) -> bool:
        if op == "batch":
            return any(isinstance(s, dict) and self._mutates(s.get("op"), s)
                       for s in hdr.get("ops") or [])
        if op == "nmp":
            nspec = NMP_OPS.get(hdr.get("kind"))
            return bool(nspec is None or nspec.mutating)
        spec = OPS.get(op)
        return bool(spec is not None and spec.mutating)

    # -- per-connection loop ----------------------------------------------------
    def _conn_writer(self, conn: socket.socket, out_q: "queue.Queue",
                     wire: int):
        """Reply pump (v2+): the reader decodes + dispatches, replies drain
        out of this queue tagged with their request's rid. Replies that
        queued up while a send was in flight are corked into a single
        send — one joined sendall for a v2 peer, one vectored sendmsg of
        every frame's segments for v3 (reply bodies are the dispatchers'
        own buffers, device-cache views included, copied nowhere on the
        way out)."""
        while True:
            item = out_q.get()
            stop = item is None
            batch = [] if stop else [item]
            while not stop:
                try:
                    item = out_q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            views = sum(nv for _, _, nv in batch)
            try:
                segs = []
                for rh, rbody, _ in batch:
                    frame, _ = pack_frame_segments(rh, rbody, wire=wire)
                    if wire >= WIRE_V3:
                        segs.extend(frame)
                    else:
                        # wire-copy: v1/v2 peers take joined frames
                        segs.append(b"".join(frame))
                if segs:
                    if wire >= WIRE_V3:
                        sendmsg_all(conn, segs)
                    else:
                        # wire-copy: one corked sendall per reply burst
                        conn.sendall(b"".join(segs))
            except (OSError, PoolError):
                # reply path broken: kill the conn so the reader unblocks
                with contextlib.suppress(OSError):
                    conn.close()
                stop = True
            finally:
                self._views_done(views)
            if stop:
                # surrender any still-queued view counts so mutators on
                # other connections don't wait out the gate timeout
                while True:
                    try:
                        item = out_q.get_nowait()
                    except queue.Empty:
                        return
                    if item is not None:
                        self._views_done(item[2])

    def _serve_conn(self, conn: socket.socket):
        if self.conn_timeout:
            conn.settimeout(self.conn_timeout)
        # buffered reads: pipelined request frames arrive back-to-back and
        # cost ~1 recv syscall per burst instead of 2 per frame
        rsock = BufferedSocket(conn)
        tenant: Optional[Tenant] = None
        # per-connection posture: hello readonly=True marks a serving
        # connection — every mutating op on it is denied with a typed
        # TenantIsolationError. Connection-level, not tenant-level: the
        # Tenant object is shared by name, and a trainer and a server may
        # legitimately share a tenant namespace with different postures.
        readonly = False
        # negotiated per connection at hello; a v1 peer (no "wire" field)
        # keeps the strict one-op-at-a-time protocol unchanged
        conn_wire = WIRE_V1
        out_q: Optional[queue.Queue] = None
        # v3 connections receive whole bursts into one pooled buffer
        # (recv_into, zero body copies): frame bodies are views of the
        # ingest buffer, reclaimed in place once dispatch consumed them
        conn_pool: Optional[BufferPool] = None
        ingest: Optional[PooledIngest] = None
        # shared-secret auth is a TCP property: unix sockets are already
        # gated by filesystem permissions. State is per connection — each
        # tcp hello must answer a fresh nonce, so proofs never replay.
        auth = {"required": bool(self.secret) and self._kind == "tcp",
                "challenge": None}

        def reply(rh: dict, rbody=b"", rid=None, views: int = 0):
            if rid is not None:
                rh["rid"] = rid
            if out_q is not None:
                self._views_add(views)
                out_q.put((rh, rbody, views))
            else:
                send_frame(conn, rh, rbody)

        try:
            while not self._stop.is_set():
                loan = None
                try:
                    if ingest is not None:
                        got = ingest.next_frame()
                        if got is None:
                            frame = None
                        else:
                            hdr, body, _, loan = got
                            frame = (hdr, body)
                    else:
                        frame = recv_frame(rsock)
                except WireError as e:
                    # a fatal wire error means frame sync is gone (corrupt
                    # length prefix, EOF mid-frame): report once and drop.
                    # On a v2 connection a NON-fatal one (bad header inside
                    # an intact frame) rejects just that request — the
                    # stream is still at a frame boundary, so keep serving.
                    try:
                        reply(error_to_frame(e))
                    except PoolError:
                        return
                    if e.fatal or conn_wire < WIRE_V2:
                        return
                    continue
                except PoolError:
                    return
                if frame is None:
                    return                  # clean EOF
                hdr, body = frame
                op = hdr.get("op")
                rid = hdr.get("rid")
                if op == "close":
                    return
                try:
                    if op == "ping":
                        # keepalive no-op: pre-hello, tenant-free, and
                        # exactly what stops an idle-timeout from
                        # mistaking a quiet pipelined trainer for a corpse
                        rh, rbody = {}, b""
                    elif op == "hello":
                        if auth["required"]:
                            self._check_auth(auth, hdr)
                        tenant = self._hello(hdr)
                        readonly = bool(hdr.get("readonly"))
                        conn_wire = min(int(hdr.get("wire", WIRE_V1)),
                                        self.wire_max)
                        rh, rbody = {"capacity": self.device.capacity,
                                     "device": self.device.profile.name,
                                     "tenant": tenant.name,
                                     "readonly": readonly,
                                     "wire": conn_wire}, b""
                    elif tenant is None:
                        raise TenantIsolationError(
                            "no tenant identity: send hello first")
                    elif op == "batch":
                        if self._mutates(op, hdr):
                            self._views_drain()
                        rh, rbody = self._run_batch(tenant, readonly, hdr,
                                                    body)
                    else:
                        if readonly:
                            self._check_readonly(tenant, op, hdr)
                        if self._mutates(op, hdr):
                            self._views_drain()
                        rh, rbody = self._dispatch(tenant, op, hdr, body)
                    rh["ok"] = True
                    nviews = 0
                    if op == "read":
                        nviews = 1
                    elif op == "batch":
                        nviews = sum(1 for s in hdr.get("ops") or []
                                     if isinstance(s, dict)
                                     and s.get("op") == "read")
                    reply(rh, rbody, rid, views=nviews)
                    if tenant is not None and op in DATA_OPS:
                        m = tenant.metrics
                        m.data_frames += 1
                        if conn_wire < WIRE_V3:
                            # pre-v3: request body staged by the buffered
                            # reader + reply body joined by the writer
                            m.bytes_copied += len(body) + sum(
                                len(s) for s in _as_segment_list(rbody))
                        elif ingest is not None:
                            # v3's only copies: partial-frame relocations
                            # when the kernel split a burst (usually 0)
                            m.bytes_copied += ingest.take_moved()
                except (PoolError, InjectedCrash) as e:
                    reply(error_to_frame(e), rid=rid)
                except Exception as e:      # defensive: typed, keep serving
                    reply(error_to_frame(
                        PoolError(f"{type(e).__name__}: {e}")), rid=rid)
                finally:
                    if loan is not None:
                        # every handler consumed the request body above;
                        # recycle its buffer for the next frame
                        loan.release()
                if conn_wire >= WIRE_V2 and out_q is None:
                    # hello settled on v2: replies move to the writer pump
                    # (the hello reply itself went out strict, above)
                    out_q = queue.Queue()
                    threading.Thread(target=self._conn_writer,
                                     args=(conn, out_q, conn_wire),
                                     daemon=True).start()
                if conn_wire >= WIRE_V3 and conn_pool is None:
                    # v3 settled: move receives to the pooled burst
                    # reader, handing over whatever the buffered reader
                    # already pulled out of the kernel
                    conn_pool = BufferPool()
                    ingest = PooledIngest(conn, conn_pool,
                                          residue=rsock.take_buffer())
        except PoolError:
            pass                            # peer vanished mid-reply
        finally:
            if out_q is not None:
                out_q.put(None)
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _check_auth(self, auth: dict, hdr: dict):
        """HMAC challenge handshake for tcp hellos. First hello without a
        valid proof gets a nonce back (typed ``PoolAuthError``); the client
        re-hellos with ``auth = HMAC-SHA256(secret, challenge:tenant)``. A
        wrong proof is a hard reject — no second nonce on that attempt."""
        proof = hdr.get("auth")
        tenant = str(hdr.get("tenant") or "default")
        if proof and auth["challenge"] \
                and hdr.get("challenge") == auth["challenge"]:
            expect = auth_proof(self.secret, auth["challenge"], tenant)
            auth["challenge"] = None           # single use either way
            if hmac.compare_digest(expect, str(proof)):
                auth["required"] = False
                return
            raise PoolAuthError("pool auth failed: wrong secret")
        auth["challenge"] = pysecrets.token_hex(16)
        raise PoolAuthError("pool auth required: answer the challenge with "
                            "HMAC-SHA256(secret, challenge:tenant)",
                            challenge=auth["challenge"])

    def _hello(self, hdr: dict) -> Tenant:
        name = str(hdr.get("tenant") or "default")
        if "::" in name or not name:
            raise PoolError(f"bad tenant name {name!r}")
        with self._lock:
            t = self.tenants.get(name)
            if t is None:
                quota = int(hdr.get("quota") or 0) or self.default_quota
                t = Tenant(name, self.device, quota)
                self.tenants[name] = t
        return t

    # -- dispatch ---------------------------------------------------------------
    def _run_batch(self, tenant: Tenant, readonly: bool, hdr: dict,
                   body: bytes):
        """Scatter-gather frame: execute the sub-ops in order, collect one
        tagged result (ok or typed error) per slot — a failed sub-op never
        aborts its siblings. The exception is ``InjectedCrash``: that
        emulates the node dying mid-batch, so execution stops there and the
        remaining slots report aborted."""
        subs = unpack_batch(hdr, body)
        results = []
        crashed: Optional[InjectedCrash] = None
        for shdr, sbody in subs:
            sop = shdr.get("op")
            if crashed is not None:
                results.append((error_to_frame(PoolError(
                    f"batch aborted: injected crash at "
                    f"{crashed.point!r} upstream")), b""))
                continue
            try:
                if sop not in OPS or sop in ("hello", "batch", "close",
                                             "ping"):
                    raise WireError(f"op {sop!r} not allowed in a batch "
                                    f"frame")
                if readonly:
                    self._check_readonly(tenant, sop, shdr)
                rh, rbody = self._dispatch(tenant, sop, shdr, sbody)
                rh["ok"] = True
                results.append((rh, rbody))
            except InjectedCrash as e:
                crashed = e
                results.append((error_to_frame(e), b""))
            except PoolError as e:
                results.append((error_to_frame(e), b""))
            except Exception as e:
                results.append((error_to_frame(
                    PoolError(f"{type(e).__name__}: {e}")), b""))
        return pack_batch_results(results)

    def _dispatch(self, tenant: Tenant, op: str, hdr: dict, body: bytes):
        handler = getattr(self, f"_op_{op.replace('-', '_')}", None)
        if op not in OPS or handler is None:
            raise WireError(f"unknown op {op!r}")
        with self._lock:
            prev = self.device.metrics
            self.device.metrics = tenant.metrics   # attribute traffic
            try:
                return handler(tenant, hdr, body)
            finally:
                self.device.metrics = prev

    def _check_owned(self, tenant: Tenant, off, nbytes):
        off, nbytes = int(off), int(nbytes)
        if off < 0 or nbytes < 0:
            raise WireError(f"bad range [{off}, {off + nbytes})")
        for s, e in tenant.owned_ranges():
            if s <= off and off + nbytes <= e:
                return off, nbytes
        raise TenantIsolationError(
            f"tenant {tenant.name!r}: access [{off}, {off + nbytes}) is "
            f"outside its owned regions")

    def _check_control(self, tenant: Tenant, op: str):
        if not self.control_ops:
            raise TenantIsolationError(
                f"tenant {tenant.name!r}: node-wide control op {op!r} is "
                f"disabled on this server (--no-control-ops)")

    def _check_readonly(self, tenant: Tenant, op: str, hdr: dict):
        """Readonly-connection gate, driven by the op registry's mutability
        flags: deny anything mutating. ``alloc`` is allowed only as an
        idempotent reopen of an existing, shape- and dtype-identical region
        (how a serving tier resolves its handles); persist (a flush cannot
        corrupt), reads, metrics, and control ops stay allowed — control
        ops have their own gate (--no-control-ops)."""
        spec = OPS.get(op)
        denied = bool(spec is not None and spec.mutating
                      and not spec.reopen_ok)
        what = op
        if op == "nmp":
            nspec = NMP_OPS.get(hdr.get("kind"))
            if nspec is not None and nspec.mutating:
                denied = True
                what = f"nmp:{hdr.get('kind')}"
        if op == "alloc":
            with self._lock:
                region = tenant.alloc.domain(hdr["domain"]).get(hdr["name"])
            if region is None or region.dtype != hdr["dtype"] \
                    or list(region.shape) != [int(s) for s in hdr["shape"]]:
                denied = True
                what = f"alloc:{hdr['domain']}/{hdr['name']}"
        if denied:
            raise TenantIsolationError(
                f"tenant {tenant.name!r}: mutating op {what!r} denied on a "
                f"readonly connection")

    # -- ops ---------------------------------------------------------------------
    def _op_read(self, tenant, hdr, body):
        off, nbytes = self._check_owned(tenant, hdr["off"], hdr["nbytes"])
        # the raw device-cache view rides the reply uncopied; the view
        # gate keeps mutators off it until the writer sent it
        arr = self.device.read(off, nbytes, tag=hdr.get("tag", "read"))
        return {}, arr

    def _op_write(self, tenant, hdr, body):
        off, _ = self._check_owned(tenant, hdr["off"], len(body))
        self.device.write(off, np.frombuffer(body, dtype=np.uint8),
                          tag=hdr.get("tag", "write"))
        return {}, b""

    def _op_persist(self, tenant, hdr, body):
        off, nbytes = hdr.get("off"), hdr.get("nbytes")
        point = hdr.get("point", "persist")
        if off is None:
            # global barrier: flushes every dirty range (stronger than the
            # tenant needs, leaks nothing)
            self.device.persist(point=point)
        else:
            if nbytes is None:
                raise WireError("clipped persist needs nbytes")
            off, nbytes = self._check_owned(tenant, off, nbytes)
            self.device.persist(off, nbytes, point=point)
        return {}, b""

    def _op_ensure(self, tenant, hdr, body):
        self._check_control(tenant, "ensure")   # unmetered device growth
        self.device.ensure(int(hdr["nbytes"]))
        return {"capacity": self.device.capacity}, b""

    def _op_capacity(self, tenant, hdr, body):
        return {"capacity": self.device.capacity}, b""

    def _op_crash(self, tenant, hdr, body):
        """Power-cycle the node: volatile cache dropped, media reloaded.
        Server-side allocator views are rebuilt from the durable directory
        (their in-memory copies may be ahead of media, like any cache)."""
        self._check_control(tenant, "crash")
        self.device.crash()
        for t in self.tenants.values():
            t.alloc = PoolAllocator(self.device, tenant=t.name,
                                    quota=t.quota)
            t.ranges = None
        return {}, b""

    def _op_set_faults(self, tenant, hdr, body):
        self._check_control(tenant, "set-faults")
        events = hdr.get("events")
        if events is None:
            self.device.faults = None
        else:
            self.device.faults = FaultSchedule(
                events=tuple(FaultEvent(**e) for e in events))
        return {}, b""

    def _op_alloc(self, tenant, hdr, body):
        region = tenant.alloc.domain(hdr["domain"]).alloc(
            hdr["name"], shape=tuple(hdr["shape"]), dtype=hdr["dtype"],
            point=hdr.get("point", "superblock"))
        tenant.ranges = None
        return {"region": _entry(region),
                "capacity": self.device.capacity}, b""

    def _op_get(self, tenant, hdr, body):
        region = tenant.alloc.domain(hdr["domain"]).get(hdr["name"])
        return {"region": _entry(region) if region else None}, b""

    def _op_regions(self, tenant, hdr, body):
        ents = tenant.alloc.domain(hdr["domain"]).regions()
        return {"regions": {n: _entry(r) for n, r in ents.items()}}, b""

    def _op_domains(self, tenant, hdr, body):
        """This tenant's domains on the node (open-time sweep + rebalance
        policy discovery)."""
        return {"domains": tenant.alloc.tenant_domains()}, b""

    def _op_free(self, tenant, hdr, body):
        freed = tenant.alloc.free_domain(
            hdr["domain"], point=hdr.get("point", "superblock"))
        tenant.ranges = None
        return {"freed": freed}, b""

    def _op_free_region(self, tenant, hdr, body):
        freed = tenant.alloc.domain(hdr["domain"]).free_region(
            hdr["name"], point=hdr.get("point", "superblock"))
        tenant.ranges = None
        return {"freed": freed}, b""

    def _op_metrics(self, tenant, hdr, body):
        if hdr.get("reset"):
            tenant.metrics.reset()
        # capacity-watermark gauges are node-wide facts sampled at snapshot
        # time (any tenant's allocator sees the shared directory)
        tenant.metrics.used_bytes = tenant.alloc.used_bytes()
        tenant.metrics.capacity_bytes = self.device.capacity
        if hdr.get("scope") == "all":
            self._check_control(tenant, "metrics:all")  # cross-tenant view
            return {"tenants": {n: t.metrics.snapshot()
                                for n, t in self.tenants.items()},
                    "snapshot": tenant.metrics.snapshot()}, b""
        return {"snapshot": tenant.metrics.snapshot()}, b""

    def _wire_region(self, tenant, ent: dict, label: str) -> Region:
        off, nbytes = self._check_owned(tenant, ent["off"], ent["nbytes"])
        return Region(self.device, "<nmp>", label, off, nbytes,
                      ent["dtype"], tuple(ent["shape"]))

    # scalar nmp operands that ride in the request header, passed through
    # to the registry executor verbatim
    _NMP_SCALARS = ("step", "slot_off", "slot_bytes", "nslots", "hdr_bytes",
                    "slots", "compress")

    def _op_nmp(self, tenant, hdr, body):
        """Decode the wire operands and hand off to the ONE nmp dispatch
        table (``protocol.NMP_OPS``); the server has no per-kind code of
        its own."""
        spec = NMP_OPS.get(hdr.get("kind"))
        if spec is None:
            raise WireError(f"unknown nmp kind {hdr.get('kind')!r}")
        region = self._wire_region(tenant, hdr["region"], "<nmp>")
        if spec.kind == "bag_gather" and len(region.shape) > 2:
            # flat row ids on the wire: never add per-table offsets here
            region = Region(region.device, region.domain, region.name,
                            region.off, region.nbytes, region.dtype,
                            (int(np.prod(region.shape[:-1])),
                             region.shape[-1]))
        log = None
        if hdr.get("log_region"):
            log = self._wire_region(tenant, hdr["log_region"], "<log>")
        idx, pos = None, 0
        if "idx_shape" in hdr:
            idx_shape = tuple(hdr["idx_shape"])
            n_idx = int(np.prod(idx_shape)) if idx_shape else 1
            idx = np.frombuffer(body[:n_idx * 8], dtype=np.int64) \
                .reshape(idx_shape)
            pos = n_idx * 8
        rows = None
        if hdr.get("rows_dtype"):
            shape = tuple(hdr["rows_shape"])
            count = int(np.prod(shape)) if shape else 1
            rows = np.frombuffer(body, dtype=hdr["rows_dtype"], count=count,
                                 offset=pos).reshape(shape)
            pos += rows.nbytes
        blob = body[pos:] if spec.blob else None
        extra = {k: hdr[k] for k in self._NMP_SCALARS if k in hdr}
        out = spec.run(self._nmp, region, idx=idx, rows=rows, blob=blob,
                       combine=hdr.get("combine", "sum"),
                       point=hdr.get("point"), log_region=log, **extra)
        return _nmp_result_frame(out)


def _nmp_result_frame(out):
    """Registry-executor result -> reply frame: None (pure mutation),
    stats dict, raw blob bytes, or a result array. Executor results are
    freshly-built buffers, so they ride the reply frame uncopied."""
    if out is None:
        return {"shape": None}, b""
    if isinstance(out, dict):
        return {"shape": None, "stats": out}, b""
    if isinstance(out, (bytes, bytearray, memoryview)):
        return {"shape": [len(out)], "dtype": "uint8"}, out
    arr = np.ascontiguousarray(out)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}, arr


def _entry(region: Region) -> dict:
    return {"off": region.off, "nbytes": region.nbytes,
            "dtype": region.dtype, "shape": list(region.shape)}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def unix_addr(directory: str, name: str = "pool.sock") -> str:
    """``unix:<directory>/<name>``, or the same name in a fresh temporary
    directory when that path is too long for a unix socket (108 bytes on
    Linux, the terminating NUL included). That directory, and the socket
    in it, are removed when the calling process exits."""
    path = os.path.join(directory, name)
    if len(os.fsencode(path)) > 100:
        import atexit
        import shutil
        import tempfile
        tmp = tempfile.mkdtemp(prefix="pool-")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        path = os.path.join(tmp, name)
        if len(os.fsencode(path)) > 100:
            raise PoolError(f"no unix socket path under 100 bytes: {path}")
    return f"unix:{path}"


def start_node(addr: str, *, backend: str = "pmem", path: str = "",
               capacity: Optional[int] = None, env: Optional[dict] = None,
               args=()):
    """Start ``python -m repro_torch.pool.server`` as a process of its own
    and wait for its ``listening`` line. Returns the ``subprocess.Popen``
    (its stdout a pipe, already read past that line); raises PoolError,
    with the process ended, if the node does not come up."""
    import subprocess
    cmd = [sys.executable, "-m", "repro_torch.pool.server", "--addr", addr,
           "--backend", backend, *args]
    if path:
        cmd += ["--path", path]
    if capacity is not None:
        cmd += ["--capacity", str(int(capacity))]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline().strip()
    if "listening" not in line:
        proc.kill()
        proc.wait()
        raise PoolError(f"memory node failed to start (exit "
                        f"{proc.returncode}): {line!r}")
    return proc


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="repro_torch.pool memory-node server")
    ap.add_argument("--addr", required=True,
                    help="unix:/path or tcp:host:port (tcp port 0 = ephemeral)")
    ap.add_argument("--backend", choices=["dram", "pmem"], default="pmem")
    ap.add_argument("--path", default="",
                    help="pmem image path (required for --backend pmem)")
    ap.add_argument("--capacity", type=int, default=1 << 22)
    ap.add_argument("--default-quota", type=int, default=0,
                    help="byte quota for tenants that don't request one "
                         "(0 = unlimited)")
    ap.add_argument("--no-control-ops", action="store_true",
                    help="deny node-wide control ops (crash / set-faults / "
                         "ensure / all-tenant metrics) to tenants")
    ap.add_argument("--pool-secret",
                    default=os.environ.get("REPRO_POOL_SECRET", ""),
                    help="shared secret for the tcp hello handshake (HMAC "
                         "challenge); env REPRO_POOL_SECRET. Unix sockets "
                         "are exempt (filesystem-gated)")
    ap.add_argument("--conn-timeout", type=float, default=600.0,
                    help="per-connection idle timeout in seconds "
                         "(0 = never drop quiet trainers; v2 clients "
                         "keepalive-ping through it)")
    ap.add_argument("--wire", type=int, choices=[1, 2, 3], default=None,
                    help="max wire protocol generation to offer "
                         "(default: v3, or REPRO_POOL_WIRE)")
    args = ap.parse_args(argv)

    if args.backend == "pmem":
        if not args.path:
            ap.error("--backend pmem needs --path")
        device = PmemPool(args.path, args.capacity)
    else:
        device = DramPool(args.capacity)

    server = PoolServer(device, args.addr,
                        default_quota=args.default_quota,
                        control_ops=not args.no_control_ops,
                        conn_timeout=args.conn_timeout or None,
                        secret=args.pool_secret, wire=args.wire)
    stop = threading.Event()

    def _sig(signum, frame):
        stop.set()
        server.shutdown(close_device=True)

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    print(f"pool-server listening on {server.addr} "
          f"(backend={args.backend}, capacity={device.capacity})",
          flush=True)
    server.serve_forever()
    print("pool-server: shut down", file=sys.stderr)


if __name__ == "__main__":
    main()
