"""The port's wire protocol (``repro_torch.pool.protocol``) against the JAX
package's, on the CPU.

The cases of ``tests/test_protocol.py`` that do not need the sharded pool,
run against the port's client, server and channel: version negotiation,
the one op table, pipelining, batch frames, torn frames, keepalives and
per-op timeouts, the v3 zero-copy path. Then the two packages are held
against each other: the op registry (names, classes, timeouts) and the
bytes of every frame the port builds (``pack_frame_segments`` under v1,
v2 and v3, the binary headers, batch frames) are the JAX package's.
Every server binds a unix socket under ``tmp_path`` and is shut down by
its fixture or a ``finally``; every client has a timeout.
"""
import socket
import struct
import threading
import time

import numpy as np
import pytest

from repro.pool import protocol as rproto
from repro_torch.pool import (DramPool, PmemPool, PoolAllocator, PoolError,
                              PoolServer, PoolTimeoutError, RemotePool,
                              Timeouts)
from repro_torch.pool import protocol, remote, server
from repro_torch.pool.protocol import (BIN_HDR_FLAG, V3_CODECS, WIRE_V1,
                                       WIRE_V2, WIRE_V3, BufferPool,
                                       PoolChannel, PoolConnectionError,
                                       RecycledBufferError, pack_v3_header,
                                       recv_frame, send_frame,
                                       unpack_v3_header, wire_from_env)


@pytest.fixture
def srv(tmp_path):
    s = PoolServer(DramPool(1 << 18), f"unix:{tmp_path}/pool.sock").start()
    yield s
    s.shutdown(close_device=True)


def _mkdata(dev, n=64, name="x", domain="d"):
    r = PoolAllocator(dev).domain(domain).alloc(name, shape=(n,),
                                                dtype="uint8")
    dev.write(r.off, np.arange(n, dtype=np.uint8))
    return r


# -- one op table, the JAX package's ------------------------------------------

def test_single_op_table():
    """The client and the server dispatch off THE registry objects of the
    port's protocol module."""
    assert remote.OPS is protocol.OPS and server.OPS is protocol.OPS
    assert remote.NMP_OPS is protocol.NMP_OPS
    assert server.NMP_OPS is protocol.NMP_OPS
    for op, spec in protocol.OPS.items():
        assert spec.name == op
    for kind, spec in protocol.NMP_OPS.items():
        assert spec.kind == kind and callable(spec.run)


def test_registry_matches_jax_package():
    """OPS, NMP_OPS and DATA_OPS: the same names, the same permission bits
    and timeout classes, the same frame codes (so both packages' servers
    gate and time every op alike)."""
    assert protocol.DATA_OPS == rproto.DATA_OPS
    assert protocol.OPS.keys() == rproto.OPS.keys()
    for op, spec in protocol.OPS.items():
        want = rproto.OPS[op]
        assert (spec.name, spec.timeout, spec.mutating, spec.reopen_ok,
                spec.control, spec.tenant) == (
            want.name, want.timeout, want.mutating, want.reopen_ok,
            want.control, want.tenant), op
    assert protocol.NMP_OPS.keys() == rproto.NMP_OPS.keys()
    for kind, spec in protocol.NMP_OPS.items():
        want = rproto.NMP_OPS[kind]
        assert (spec.mutating, spec.timeout, spec.blob) == (
            want.mutating, want.timeout, want.blob), kind
    assert {k: (c.code, c.fields) for k, c in protocol.V3_CODECS.items()} \
        == {k: (c.code, c.fields) for k, c in rproto.V3_CODECS.items()}
    for name in ("MAX_FRAME", "BIN_HDR_FLAG", "WIRE_V1", "WIRE_V2",
                 "WIRE_V3"):
        assert getattr(protocol, name) == getattr(rproto, name), name
    t, rt = Timeouts(), rproto.Timeouts()
    assert (t.control, t.data, t.bulk, t.keepalive, t.BULK_BW_FLOOR) == (
        rt.control, rt.data, rt.bulk, rt.keepalive, rt.BULK_BW_FLOOR)
    for knob in (None, 0.5, 7.0, 300.0):
        a, b = Timeouts.resolve(knob), rproto.Timeouts.resolve(knob)
        assert (a.control, a.data, a.bulk, a.keepalive, a.tick()) == (
            b.control, b.data, b.bulk, b.keepalive, b.tick()), knob


_REGION = {"off": 4096, "nbytes": 8192, "dtype": "float32", "shape": [64, 32]}
_HEADERS = [
    ({"op": "hello", "tenant": "t", "quota": 0, "wire": 3}, b""),
    ({"op": "read", "off": 4096, "nbytes": 65536, "tag": "view", "rid": 7},
     b""),
    ({"op": "write", "off": 64, "tag": "mirror-load", "rid": 2},
     np.arange(40, dtype=np.float32)),
    ({"op": "nmp", "kind": "gather", "combine": "sum", "point": None,
      "region": _REGION, "idx_shape": [5], "rid": 9},
     [np.arange(5, dtype=np.int64)]),
    ({"op": "nmp", "kind": "undo_log_append", "combine": "sum",
      "point": "mirror-apply", "region": _REGION, "idx_shape": [3],
      "rows_dtype": "float32", "rows_shape": [3, 32],
      "log_region": {"off": 65536, "nbytes": 4096, "dtype": "uint8",
                     "shape": [4096]},
      "step": 4, "slot_off": 65536, "slot_bytes": 2048, "compress": "zlib",
      "rid": 11},
     [np.arange(3, dtype=np.int64), np.ones((3, 32), np.float32)]),
    ({"op": "nmp", "kind": "slot_clear", "combine": "sum", "point": "undo-gc",
      "region": _REGION, "slots": [1, 2], "slot_bytes": 64, "rid": 12}, b""),
    ({"op": "nmp", "kind": "blob_put", "combine": "sum", "point": "dense",
      "region": _REGION, "compress": "none", "rid": 13}, b"\x01" * 100),
    ({"op": "capacity", "rid": 3}, b""),
    ({"ok": True, "rid": 5}, b""),
    ({"ok": True, "rid": 6, "shape": [2, 3], "dtype": "float32"},
     np.zeros((2, 3), np.float32)),
    ({"ok": False, "kind": "WireError", "error": "bad", "rid": 8}, b""),
    ({"ok": True, "capacity": 1 << 20, "rid": 4}, b""),
]


@pytest.mark.parametrize("wire", [WIRE_V1, WIRE_V2, WIRE_V3])
def test_frame_bytes_match_jax_package(wire):
    """Every frame, its binary (v3) or JSON header, and the batch frames of
    requests and replies: the JAX package's bytes."""
    for hdr, body in _HEADERS:
        got, n = protocol.pack_frame_segments(hdr, body, wire=wire)
        want, rn = rproto.pack_frame_segments(hdr, body, wire=wire)
        assert n == rn and b"".join(map(bytes, got)) == \
            b"".join(map(bytes, want)), hdr
        assert protocol.pack_v3_header(hdr) == rproto.pack_v3_header(hdr)
        assert protocol.pack_v3_reply_header(hdr) == \
            rproto.pack_v3_reply_header(hdr)
    assert protocol.pack_frame(*_HEADERS[2]) == rproto.pack_frame(*_HEADERS[2])
    reqs = [(h, b) for h, b in _HEADERS if "op" in h]
    (bh, bb), (rh, rb) = protocol.pack_batch(reqs), rproto.pack_batch(reqs)
    assert bh == rh and b"".join(map(bytes, bb)) == b"".join(map(bytes, rb))
    reps = [(h, b) for h, b in _HEADERS if "ok" in h]
    (bh, bb), (rh, rb) = (protocol.pack_batch_results(reps),
                          rproto.pack_batch_results(reps))
    assert bh == rh and b"".join(map(bytes, bb)) == b"".join(map(bytes, rb))
    body = memoryview(b"".join(map(bytes, bb)))
    assert [(h, bytes(s)) for h, s in protocol.unpack_batch_results(bh, body)] \
        == [(h, bytes(s)) for h, s in rproto.unpack_batch_results(rh, body)]
    # a binary header the JAX package built decodes to the same dict here
    for hdr, _ in _HEADERS:
        bh = rproto.pack_v3_header(hdr) if "op" in hdr else \
            rproto.pack_v3_reply_header(hdr)
        if bh is not None:
            assert unpack_v3_header(memoryview(bh)) == \
                rproto.unpack_v3_header(memoryview(bh))


def test_errors_cross_by_class_name():
    """A typed error frame names its class: the port's classes map to the
    JAX package's and back (the extra fields of InjectedCrash and
    PoolAuthError too)."""
    from repro.pool import remote as rremote
    from repro_torch.pool import (InjectedCrash, QuotaExceededError,
                                  TenantIsolationError)
    from repro_torch.pool.remote import PoolAuthError
    for exc in (QuotaExceededError("q"), TenantIsolationError("t"),
                protocol.WireError("w"), PoolConnectionError("c"),
                InjectedCrash("undo-commit", 3),
                PoolAuthError("auth", challenge="ab12")):
        frame = protocol.error_to_frame(exc)
        back = rproto.frame_to_error(frame)
        assert type(back).__name__ == type(exc).__name__
        assert rproto.error_to_frame(back) == frame
        assert type(protocol.frame_to_error(frame)) is type(exc)
    assert rremote.PoolAuthError.__name__ == PoolAuthError.__name__


# -- version negotiation ------------------------------------------------------

@pytest.mark.parametrize("client,srv_wire,want", [
    (None, WIRE_V1, WIRE_V1), (WIRE_V1, None, WIRE_V1),
    (None, None, WIRE_V3), (WIRE_V2, None, WIRE_V2), (None, WIRE_V2, WIRE_V2),
])
def test_version_negotiation(tmp_path, client, srv_wire, want):
    """Both ends settle on the lower generation and round-trip data; on v1
    the async surface degrades to completed depth-1 futures."""
    s = PoolServer(DramPool(1 << 18), f"unix:{tmp_path}/v.sock",
                   wire=srv_wire).start()
    try:
        dev = RemotePool(s.addr, timeout=20.0, wire=client)
        assert dev.wire == want and dev.wire_stats()["wire"] == want
        r = _mkdata(dev)
        assert bytes(dev.read(r.off, 8)) == bytes(range(8))
        assert bytes(dev.read_async(r.off, 8).result()) == bytes(range(8))
        assert [bytes(b) for b in dev.read_batch([(r.off, 4),
                                                  (r.off + 4, 4)])] == \
            [bytes(range(4)), bytes(range(4, 8))]
        dev.close()
    finally:
        s.shutdown(close_device=True)


def test_wire_from_env(monkeypatch):
    for raw, want in (("v1", WIRE_V1), ("2", WIRE_V2), ("v3", WIRE_V3),
                      ("3", WIRE_V3)):
        monkeypatch.setenv("REPRO_POOL_WIRE", raw)
        assert wire_from_env() == want
    monkeypatch.delenv("REPRO_POOL_WIRE")
    assert wire_from_env() == WIRE_V3


# -- pipelining ---------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dram", "pmem", "remote"])
def test_pipeline_depth8_parity(tmp_path, backend):
    """Depth-8 pipelined reads and one batch frame give the bytes of
    sequential reads on every backend the port has."""
    s = None
    if backend == "dram":
        dev = DramPool(1 << 18)
    elif backend == "pmem":
        dev = PmemPool(str(tmp_path / "p.img"), 1 << 18)
    else:
        s = PoolServer(DramPool(1 << 18), f"unix:{tmp_path}/r.sock").start()
        dev = RemotePool(s.addr, timeout=20.0)
    try:
        r = _mkdata(dev, n=256)
        seq = [bytes(dev.read(r.off + 8 * i, 8)) for i in range(8)]
        futs = [dev.read_async(r.off + 8 * i, 8) for i in range(8)]
        assert [bytes(f.result()) for f in futs] == seq
        assert [bytes(b) for b in dev.read_batch(
            [(r.off + 8 * i, 8) for i in range(8)])] == seq
        dev.close()
    finally:
        if s is not None:
            s.shutdown(close_device=True)


def test_pipelined_error_rejects_only_its_future(srv):
    dev = RemotePool(srv.addr, timeout=20.0)
    assert dev.wire == WIRE_V3
    r = _mkdata(dev)
    good1 = dev.read_async(r.off, 8)
    bad = dev.read_async(1 << 29, 8)        # beyond capacity: typed error
    good2 = dev.read_async(r.off + 8, 8)
    assert bytes(good1.result()) == bytes(range(8))
    with pytest.raises(PoolError):
        bad.result()
    assert bytes(good2.result()) == bytes(range(8, 16))
    assert not dev.closed
    assert bytes(dev.read(r.off, 4)) == bytes(range(4))
    dev.close()


def test_batch_frame_is_one_round_trip(srv):
    dev = RemotePool(srv.addr, timeout=20.0)
    r = _mkdata(dev, n=128)
    calls = []
    orig = dev._request

    def counting(hdr, body=b""):
        calls.append(hdr["op"])
        return orig(hdr, body)

    dev._request = counting
    try:
        got = dev.read_batch([(r.off + i, 1) for i in range(16)])
    finally:
        dev._request = orig
    assert calls == ["batch"]
    assert b"".join(bytes(b) for b in got) == bytes(range(16))
    dev.close()


# -- torn frames --------------------------------------------------------------

def _raw_hello(sock, wire=WIRE_V2):
    send_frame(sock, {"op": "hello", "tenant": "torn", "quota": 0,
                      "wire": wire})
    hdr, _ = recv_frame(sock)
    assert hdr.get("ok"), hdr
    return int(hdr.get("wire", WIRE_V1))


def _raw_socket(srv):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(protocol.parse_addr(srv.addr)[1])
    sock.settimeout(10.0)
    return sock


@pytest.mark.parametrize("wire", [WIRE_V2, WIRE_V3])
def test_torn_frame_mid_pipeline_rejects_exactly_one(srv, wire):
    """A frame whose header fails to parse (JSON garbage on v2, an unknown
    binary op code on v3) gets ONE error reply without a rid; the requests
    around it succeed and the connection keeps serving."""
    sock = _raw_socket(srv)
    try:
        assert _raw_hello(sock, wire) == wire
        send_frame(sock, {"op": "capacity", "rid": 1})
        if wire == WIRE_V2:
            garbage = b"\x00not json at all\xff"
            sock.sendall(struct.pack("<I", 4 + len(garbage))
                         + struct.pack("<I", len(garbage)) + garbage)
        else:
            bh = struct.pack("<HHQ", 127, 0, 2)
            sock.sendall(struct.pack("<II", 4 + len(bh),
                                     len(bh) | BIN_HDR_FLAG) + bh)
        send_frame(sock, {"op": "capacity", "rid": 3})
        replies = [recv_frame(sock)[0] for _ in range(3)]
        by_rid = {h.get("rid"): h for h in replies}
        assert by_rid[1]["ok"] and by_rid[3]["ok"]
        (err,) = [h for h in replies if not h.get("ok")]
        assert err.get("rid") is None
        send_frame(sock, {"op": "capacity", "rid": 4})
        hdr, _ = recv_frame(sock)
        assert hdr["ok"] and hdr["rid"] == 4
    finally:
        sock.close()


def test_fatal_framing_error_still_drops_connection(srv):
    sock = _raw_socket(srv)
    try:
        assert _raw_hello(sock) == WIRE_V2
        sock.sendall(struct.pack("<I", (1 << 30) + 1))   # > MAX_FRAME
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if recv_frame(sock) is None:
                break                        # the server hung up
        else:
            pytest.fail("server kept the connection after frame desync")
    finally:
        sock.close()


# -- keepalive / timeouts -----------------------------------------------------

@pytest.mark.parametrize("wire", [WIRE_V1, WIRE_V3])
def test_idle_connection(tmp_path, wire):
    """A quiet pipelined connection outlives the server's idle timeout by
    pinging under it; a v1 connection has no keepalive and is reaped."""
    s = PoolServer(DramPool(1 << 18), f"unix:{tmp_path}/ka.sock",
                   conn_timeout=1.0).start()
    try:
        dev = RemotePool(s.addr, wire=wire, timeout=Timeouts(
            control=5.0, data=10.0, bulk=20.0, keepalive=0.3))
        r = _mkdata(dev)
        time.sleep(2.5)                      # > 2x the server conn_timeout
        if wire == WIRE_V1:
            with pytest.raises(PoolConnectionError):
                dev.ping()
        else:
            assert bytes(dev.read(r.off, 8)) == bytes(range(8))
            assert dev.wire_stats()["pings"] > 0
            dev.close()
    finally:
        s.shutdown(close_device=True)


def test_per_op_timeout_rejects_one_request_connection_survives(tmp_path):
    path = str(tmp_path / "stall.sock")
    lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lsock.bind(path)
    lsock.listen(1)
    stop = threading.Event()

    def fake_server():
        conn, _ = lsock.accept()
        conn.settimeout(20.0)
        hdr, _ = recv_frame(conn)
        assert hdr["op"] == "hello"
        send_frame(conn, {"ok": True, "wire": WIRE_V2})
        while not stop.is_set():
            got = recv_frame(conn)
            if got is None:
                break
            h, _ = got
            if h["op"] == "capacity":
                time.sleep(1.2)              # stall past the op deadline
            if h["op"] == "close":
                break
            send_frame(conn, {"ok": True, "capacity": 1 << 18,
                              "rid": h.get("rid")})
        conn.close()

    t = threading.Thread(target=fake_server, daemon=True)
    t.start()
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(path)
    chan = PoolChannel(sock, f"unix:{path}",
                       Timeouts(control=0.4, data=0.4, bulk=1.0,
                                keepalive=30.0))
    try:
        hdr, _ = chan.exchange({"op": "hello", "tenant": "t", "quota": 0,
                                "wire": WIRE_V2})
        chan.activate(int(hdr["wire"]))
        with pytest.raises(PoolTimeoutError):
            chan.submit({"op": "capacity"}).result()
        rh, _ = chan.request({"op": "ping"}, timeout=5.0)
        assert rh.get("ok") and chan.stats()["timeouts"] == 1
        deadline = time.monotonic() + 5.0
        while chan.stats()["late_drops"] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert chan.stats()["late_drops"] >= 1
    finally:
        stop.set()
        chan.close()
        lsock.close()


@pytest.mark.parametrize("wire", [WIRE_V2, WIRE_V3])
def test_reply_body_may_pause_past_the_reader_tick(tmp_path, wire):
    """A reply whose body pauses mid-frame for longer than the channel's
    reader tick (0.1 s here) completes: the reader waits a begun frame out
    up to the data-class deadline. The JAX package's channel drops the
    connection there, which a split read of a full-width mirror (64 MiB
    frames) can meet on a busy host."""
    path = str(tmp_path / "slow.sock")
    lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lsock.bind(path)
    lsock.listen(2)
    body = bytes(range(256)) * 256

    def fake_server():
        for _ in range(2):                   # the port's client, then the JAX's
            conn, _ = lsock.accept()
            conn.settimeout(20.0)
            recv_frame(conn)                 # hello
            send_frame(conn, {"ok": True, "wire": wire})
            # a v3 request comes with a binary header
            got = protocol.recv_frame_pooled(conn, BufferPool())
            if got is not None:
                frame = protocol.pack_frame({"ok": True, "rid": got[0]["rid"]},
                                            body)
                conn.sendall(frame[:len(frame) // 2])
                time.sleep(0.6)              # the body pauses mid-frame
                try:
                    conn.sendall(frame[len(frame) // 2:])
                except OSError:
                    pass                     # the JAX client hung up
            conn.close()

    t = threading.Thread(target=fake_server, daemon=True)
    t.start()
    ticks = dict(control=0.4, data=5.0, bulk=10.0, keepalive=30.0)
    try:
        for Chan, T, ok in ((PoolChannel, Timeouts, True),
                            (rproto.PoolChannel, rproto.Timeouts, False)):
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.connect(path)
            chan = Chan(sock, f"unix:{path}", T(**ticks))
            hdr, _ = chan.exchange({"op": "hello", "tenant": "t", "wire": wire})
            chan.activate(int(hdr["wire"]))
            fut = chan.submit({"op": "read", "off": 0, "nbytes": len(body)})
            if ok:
                _, got = fut.result()
                assert bytes(got) == body
                st = chan.stats()        # the pause was counted and timed
                assert st["stalls"] == 1
                assert 0.3 < st["stall_s_max"] == st["stall_s_total"] < 5.0
            else:
                with pytest.raises(rproto.PoolConnectionError,
                                   match="timed out"):
                    fut.result()
            chan.close()
    finally:
        t.join(timeout=10)
        lsock.close()


def test_timeouts_scale_with_payload():
    """The flat bulk deadline is the floor; a bulk op gets transfer time at
    the modelled 4 MB/s on top. At the full-width sizes: a 170 MB dense
    blob gets its transfer time, and a split read or write's frame (a
    sixteenth of the 1 GiB cap) fits its flat data deadline at that rate."""
    t = Timeouts(control=5.0, data=10.0, bulk=30.0, keepalive=0.0)
    flat = t.for_hdr({"op": "nmp", "kind": "region_export",
                      "region": {"off": 0, "nbytes": 1024}})
    assert flat == pytest.approx(30.0, abs=1e-3)
    big = t.for_hdr({"op": "nmp", "kind": "region_export",
                     "region": {"off": 0, "nbytes": 40 * (1 << 20)}})
    assert big == pytest.approx(30.0 + 40 * (1 << 20) / t.BULK_BW_FLOOR)
    assert t.for_hdr({"op": "nmp", "kind": "blob_put"},
                     nbytes=80 * (1 << 20)) > \
        t.for_hdr({"op": "nmp", "kind": "blob_put"}, nbytes=0)
    assert t.for_hdr({"op": "read"}, nbytes=1 << 30) == 10.0
    d = Timeouts()
    blob = 170 * 10 ** 6
    assert d.for_hdr({"op": "nmp", "kind": "blob_put"}, nbytes=blob) >= \
        blob / d.BULK_BW_FLOOR
    assert remote.chunk_bytes() == protocol.MAX_FRAME // 16
    assert d.for_hdr({"op": "write"}, nbytes=remote.chunk_bytes()) \
        * d.BULK_BW_FLOOR >= remote.chunk_bytes()


# -- wire v3: binary headers, zero-copy bodies, pooled buffers ----------------

def test_v3_binary_header_roundtrip_over_the_wire(srv):
    dev = RemotePool(srv.addr, timeout=20.0)
    assert dev.wire == WIRE_V3
    r = _mkdata(dev, n=128)
    dev.write(r.off, np.arange(128, dtype=np.uint8)[::-1].copy())
    assert bytes(dev.read(r.off, 4)) == bytes([127, 126, 125, 124])
    got = dev.read_batch([(r.off, 4), (r.off + 4, 4)])
    assert bytes(got[1]) == bytes([123, 122, 121, 120])
    for name in ("read", "write", "gather", "bag_gather",
                 "undo_log_append", "slot_headers", "region_export",
                 "region_import", "blob_put"):
        assert name in V3_CODECS, name
    dev.close()


def test_v3_data_path_copies_zero_bytes(srv):
    """On a v3 connection neither side copies data bytes; on v2 both do."""
    dev = RemotePool(srv.addr, timeout=20.0, tenant="zc")
    assert dev.wire == WIRE_V3
    r = PoolAllocator(dev).domain("zc").alloc("m", shape=(16, 8),
                                              dtype="float32")
    dev.write(r.off, np.arange(128, dtype=np.float32).reshape(16, 8))
    assert bytes(dev.read(r.off, 16)) == \
        np.arange(4, dtype=np.float32).tobytes()
    dev.read_batch([(r.off, 8), (r.off + 8, 8)])
    assert dev.nmp("gather", r, idx=np.array([1, 3])).shape == (2, 8)
    st = dev.wire_stats()
    assert st["data_frames"] >= 4 and st["bytes_copied"] == 0
    assert st["recv_pool"]["acquired"] > 0
    m = srv.tenants["zc"].metrics
    assert m.data_frames >= 4 and m.bytes_copied == 0
    dev.close()
    dev2 = RemotePool(srv.addr, timeout=20.0, tenant="zc2", wire=WIRE_V2)
    r2 = PoolAllocator(dev2).domain("zc2").alloc("m", shape=(64,),
                                                 dtype="uint8")
    dev2.write(r2.off, np.arange(64, dtype=np.uint8))
    bytes(dev2.read(r2.off, 64))
    assert dev2.wire_stats()["bytes_copied"] > 0
    assert srv.tenants["zc2"].metrics.bytes_copied > 0
    dev2.close()


def test_v3_codec_pack_unpack_roundtrip():
    hdrs = [
        {"op": "read", "off": 4096, "nbytes": 65536, "rid": 7},
        {"op": "write", "off": 0, "rid": 1},
        {"op": "nmp", "kind": "gather", "rid": 9, "region": _REGION,
         "combine": "sum", "point": None},
    ]
    for hdr in hdrs:
        bh = pack_v3_header(hdr)
        assert bh is not None, hdr
        back = unpack_v3_header(memoryview(bh))
        for k, v in hdr.items():
            assert back[k] == v, (k, hdr)
    assert pack_v3_header({"op": "capacity", "rid": 1}) is None
    assert pack_v3_header({"op": "read", "off": 0, "nbytes": 8,
                           "weird": 1}) is None


def test_buffer_pool_reuse_after_release_is_typed_violation():
    pool = BufferPool(max_free=4)
    loan = pool.acquire(64)
    loan.view()[:4] = b"abcd"
    assert bytes(loan.view()[:4]) == b"abcd"
    loan.release()
    loan.release()                           # double release: no-op
    again = pool.acquire(32)                 # recycles the same buffer
    assert pool.stats()["reused"] == 1
    with pytest.raises(RecycledBufferError):
        loan.view()
    keeper = pool.acquire(16)
    keeper.view()[:2] = b"ok"
    keeper.detach()
    keeper.release()                         # no-op on a detached loan
    again.release()
    for _ in range(8):
        pool.acquire(16).release()
    assert bytes(keeper.view()[:2]) == b"ok"


def test_channel_recycles_recv_buffers_across_requests(srv):
    dev = RemotePool(srv.addr, timeout=20.0)
    r = _mkdata(dev)
    blob = np.arange(64, dtype=np.uint8)
    for _ in range(16):
        dev.write(r.off, blob)
    assert dev.wire_stats()["recv_pool"]["reused"] > 0
    dev.close()
