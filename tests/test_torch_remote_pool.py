"""The port's memory node (``repro_torch.pool.server``) and its client
(``repro_torch.pool.remote``) against the JAX package's, on the CPU.

The cases of ``tests/test_remote_pool.py``, run against the port's modules:
device semantics over the wire, tenants (namespaces, quotas, isolation,
per-tenant counters), bad frames, a node restart, the fused undo append's
link bytes, the undo ring's one-round-trip scan and GC, tcp auth, and
read-only tenants. Then the two packages are held against each other:
each package's client against the other's server under wire v1, v2 and v3
(every data and nmp op bitwise equal, equal link bytes), a read and a
write of more than a frame cap's worth (shrunk for speed) against both
servers, and the trainer-death drill: the port's trainer checkpoints into
the port's node, its socket is dropped without a close, and the mirror
recovered over a fresh connection is bitwise the pmem run's; a checkpoint
the JAX trainer wrote into the JAX package's node recovers through the
port. Every server binds a unix socket under ``tmp_path`` (or tcp port 0)
and is shut down in a fixture or a ``finally``; every client has a
timeout.
"""
import os
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

import repro.pool as R
from repro.core.checkpoint.undo_log import UndoRing as RUndoRing
from repro.pool import protocol as rproto
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.core.checkpoint.undo_log import UndoRing, open_ring
from repro_torch.data.synthetic import make_batches
from repro_torch.pool import (DramPool, FaultSchedule, InjectedCrash, NmpQueue,
                              PmemPool, PoolAllocator, PoolAuthError,
                              PoolConnectionError, PoolError, PoolServer,
                              QuotaExceededError, RemotePool,
                              TenantIsolationError, make_pool, parse_addr)
from repro_torch.pool import protocol
from repro_torch.pool.remote import auth_proof, recv_frame, send_frame
from repro_torch.training import train_loop

COMPRESS = "zlib"
ARCHS = ["dlrm-rm1", "tinyllama-1.1b"]
RESUME_TOL = 1e-6        # tests/test_torch_checkpoint.py's resume tolerance


@pytest.fixture
def server(tmp_path):
    srv = PoolServer(DramPool(1 << 18), f"unix:{tmp_path}/pool.sock").start()
    yield srv
    srv.shutdown(close_device=True)


def connect(srv, tenant="default", quota=0, **kw):
    return RemotePool(srv.addr, tenant=tenant, quota=quota, timeout=20.0,
                      **kw)


# -- device semantics over the wire ------------------------------------------

def test_roundtrip_persist_crash(server, rng):
    dev = connect(server)
    r = PoolAllocator(dev).domain("d").alloc("x", shape=(16, 4),
                                             dtype="float32")
    v1 = rng.standard_normal((16, 4)).astype(np.float32)
    r.write_array(v1)
    r.persist(point="p")
    r.write_array(v1 * 2)                   # never persisted
    np.testing.assert_array_equal(r.read_array(), v1 * 2)
    dev.crash()                             # node power-cycle
    np.testing.assert_array_equal(r.read_array(), v1)
    assert dev.metrics.crashes == 1
    r2 = PoolAllocator(connect(server)).domain("d").get("x")
    assert r2 is not None and r2.off == r.off
    np.testing.assert_array_equal(r2.read_array(), v1)


def test_make_pool_remote(server):
    dev = make_pool("remote", addr=server.addr, tenant="t")
    assert dev.backend == "remote" and dev.capacity > 0
    with pytest.raises(PoolError, match="needs a server addr"):
        make_pool("remote")
    dev.close()
    with pytest.raises(PoolError):
        dev.read(0, 1)                      # closed client device


def test_nmp_over_wire_matches_numpy(server, rng):
    dev = connect(server, tenant="nmp")
    tab = rng.standard_normal((32, 8)).astype(np.float32)
    r = PoolAllocator(dev).domain("emb").alloc("t", shape=tab.shape,
                                               dtype="float32")
    r.write_array(tab)
    q = NmpQueue(dev)
    idx = np.array([3, 31, 0, 3])
    np.testing.assert_array_equal(q.gather(r, idx), tab[idx])
    bags = rng.integers(0, 32, (5, 4))
    np.testing.assert_allclose(q.bag_gather(r, bags), tab[bags].sum(1),
                               rtol=1e-6)
    np.testing.assert_array_equal(q.undo_snapshot(r, np.array([1, 2])),
                                  tab[[1, 2]])
    q.row_update(r, np.array([1, 2]), np.ones((2, 8), np.float32),
                 point="apply")
    dev.crash()                             # row_update persisted
    np.testing.assert_array_equal(r.read_array()[[1, 2]],
                                  np.ones((2, 8), np.float32))
    before = r.read_array().copy()
    q.scatter_add(r, np.array([0, 0, 5]), np.ones((3, 8), np.float32))
    exp = before.copy()
    np.add.at(exp, [0, 0, 5], np.ones((3, 8), np.float32))
    np.testing.assert_allclose(r.read_array(), exp, rtol=1e-6)
    # queued ops run at drain; a batch is one frame
    q.submit(q.gather, r, np.array([4]))
    q.submit(q.undo_snapshot, r, np.array([6]))
    got = q.drain()
    np.testing.assert_array_equal(got[0], exp[[4]])
    np.testing.assert_array_equal(got[1], exp[[6]])
    got = q.batch([("gather", r, {"idx": np.array([7])})])
    np.testing.assert_array_equal(got[0], exp[[7]])
    m = dev.metrics                         # attributed to this tenant
    assert m.media_bytes("bag_gather") > 0 and m.ndp_time_s > 0
    assert m.link_bytes() > 0


def test_stacked_bags_flat_on_the_wire(server, rng):
    """Bags over stacked (T, R, d) tables: the client adds each table's row
    offset and names the region flat, so the port's node, the JAX
    package's node and a local device reduce the same rows (the node never
    adds the offsets a second time)."""
    T, Rr, d = 3, 10, 4
    tab = rng.standard_normal((T, Rr, d)).astype(np.float32)
    ids = rng.integers(0, Rr, (6, T, 2))
    want = np.stack([tab[t][ids[:, t]].sum(-2) for t in range(T)], 1)
    local = DramPool(1 << 16)
    for dev in (connect(server, tenant="stk"), local):
        r = PoolAllocator(dev).domain("e").alloc("t", shape=tab.shape,
                                                 dtype="float32")
        r.write_array(tab)
        np.testing.assert_allclose(NmpQueue(dev).bag_gather(r, ids), want,
                                   rtol=1e-6)
    # the JAX package's client sends a (T, R, d) region with offset ids
    rdev = R.RemotePool(server.addr, tenant="stk", timeout=20.0)
    rr = R.PoolAllocator(rdev).domain("e").get("t")
    off = np.arange(T)[None, :, None] * Rr
    np.testing.assert_allclose(R.NmpQueue(rdev).bag_gather(rr, ids,
                                                           offsets=off),
                               want, rtol=1e-6)
    rdev.close()


def test_faults_armed_over_wire(server):
    dev = connect(server)
    r = PoolAllocator(dev).domain("d").alloc("x", shape=(1024,),
                                             dtype="float32")
    r.write_array(np.zeros(1024, np.float32))
    r.persist(point="init")
    dev.faults = FaultSchedule.torn_at("apply", occurrence=1)
    r.write_array(np.full(1024, 3.0, np.float32))
    with pytest.raises(InjectedCrash):
        r.persist(point="apply")
    dev.faults = None
    dev.crash()
    v = r.read_array()
    assert (v == 3.0).any() and (v == 0.0).any()    # the torn write
    assert dev.metrics.torn_writes == 1


# -- tenants ------------------------------------------------------------------

def test_tenant_namespaces_are_disjoint(server, rng):
    a, b = connect(server, tenant="a"), connect(server, tenant="b")
    ra = PoolAllocator(a).domain("emb").alloc("t", shape=(8,),
                                              dtype="float32")
    rb = PoolAllocator(b).domain("emb").alloc("t", shape=(16,),
                                              dtype="float32")
    assert (ra.off, ra.nbytes) != (rb.off, rb.nbytes)
    va = rng.standard_normal(8).astype(np.float32)
    vb = rng.standard_normal(16).astype(np.float32)
    ra.write_array(va)
    rb.write_array(vb)
    np.testing.assert_array_equal(ra.read_array(), va)
    np.testing.assert_array_equal(rb.read_array(), vb)
    assert PoolAllocator(b).domain("emb").get("t").nbytes == rb.nbytes
    assert a.list_remote_domains() == ["emb"]


def test_cross_tenant_access_denied(server, rng):
    a = connect(server, tenant="a")
    ra = PoolAllocator(a).domain("emb").alloc("t", shape=(64,),
                                              dtype="float32")
    ra.write_array(rng.standard_normal(64).astype(np.float32))
    eve = connect(server, tenant="eve")
    for attempt in (lambda: eve.read(ra.off, ra.nbytes),
                    lambda: eve.write(ra.off, np.zeros(8, np.uint8)),
                    lambda: eve.persist(ra.off, ra.nbytes, point="steal"),
                    lambda: NmpQueue(eve).gather(ra, np.array([0])),
                    lambda: eve.read(0, 64)):   # the superblock: nobody's
        with pytest.raises(TenantIsolationError):
            attempt()
    re_ = PoolAllocator(eve).domain("emb").alloc("t", shape=(4,),
                                                 dtype="float32")
    assert re_.off != ra.off
    assert PoolAllocator(eve).free_domain("emb")
    assert PoolAllocator(eve).domain("emb").get("t") is None
    assert PoolAllocator(a).domain("emb").get("t").off == ra.off


def test_quota_enforced_idempotent_and_released(server):
    """A reopen never counts twice; past the quota an alloc is refused; a
    freed region's bytes count no more."""
    dev = connect(server, tenant="q", quota=1 << 12)
    a = PoolAllocator(dev)
    r = a.domain("d").alloc("x", shape=(1 << 10,), dtype="uint8")
    with pytest.raises(QuotaExceededError):
        a.domain("d").alloc("big", shape=(1 << 13,), dtype="uint8")
    assert a.domain("d").alloc("x", shape=(1 << 10,), dtype="uint8").off \
        == r.off
    a.domain("d").alloc("y", shape=(1 << 10,), dtype="uint8")
    with pytest.raises(QuotaExceededError):
        a.domain("d").alloc("z", shape=(1 << 11) + 1024, dtype="uint8")
    assert a.domain("d").free_region("x")        # free-then-alloc fits
    a.domain("d").alloc("z", shape=(1 << 11,), dtype="uint8")
    assert a.domain("d").get("x") is None
    node = server.tenants["q"].alloc
    assert node.tenant_used() == (1 << 10) + (1 << 11)
    assert node.tenant_domains() == ["d"]
    assert len(node.owned_ranges()) == 2


def test_per_tenant_metrics_attribution(server, rng):
    a = connect(server, tenant="worker-a")
    b = connect(server, tenant="worker-b")
    ra = PoolAllocator(a).domain("d").alloc("x", shape=(256,),
                                            dtype="float32")
    ra.write_array(rng.standard_normal(256).astype(np.float32))
    ra.persist(point="p")
    snaps = a.metrics_snapshot(scope="all")
    assert snaps["worker-a"]["media_bytes"] > 0
    assert snaps["worker-b"]["media_bytes"] == 0
    assert b.metrics.media_bytes() == 0
    a.reset_metrics()
    assert a.metrics.media_bytes() == 0


def test_metrics_snapshot_matches_jax():
    """The counters a node ships (``snapshot``) rebuild (``from_snapshot``)
    in either package to the same report; ``media_bytes`` sums the kinds
    asked for, ``record_link`` times bytes at the link's rate."""
    from repro.pool.metrics import PoolMetrics as RMetrics
    from repro_torch.pool import PoolMetrics
    from repro_torch.sim import devices as dv
    m, r = PoolMetrics(device_name="pmem"), RMetrics(device_name="pmem")
    for x in (m, r):
        x.record("undo", 100, 1e-6)
        x.record("gather", 40, 2e-6)
        x.record_link("link_in", 64)
        x.record_comp(200, 50, 1e-3, kind="undo")
        x.record_cache(hits=3, misses=1)
        x.bytes_copied, x.data_frames = 7, 2
    assert m.media_bytes("undo") == 100 and m.media_bytes() == 140
    assert m.link["link_in"].time_s == 64 / dv.CXL_LINK.bw
    snap = m.snapshot()
    assert snap.keys() <= r.snapshot().keys()
    assert RMetrics.from_snapshot(snap).report() == r.report() == \
        PoolMetrics.from_snapshot(r.snapshot()).report()
    assert PoolMetrics.from_snapshot(snap).snapshot() == snap
    m.reset()
    assert m.media_bytes() == m.link_bytes() == m.bytes_copied == 0


def test_readonly_tenant(server, rng):
    """A read-only connection reopens and reads what a writer left; every
    write, new region, free and mutating nmp op is refused (the allocator
    refuses before the wire, the node on it), and the undo ring opens as a
    pure reader."""
    w = connect(server, tenant="srv")
    tab = rng.standard_normal((16, 4)).astype(np.float32)
    r = PoolAllocator(w).domain("embedding-mirror").alloc(
        "rows", shape=tab.shape, dtype="float32")
    r.write_array(tab)
    ring = UndoRing(PoolAllocator(w), max_logs=4, compress=COMPRESS)
    ring.log_and_apply(0, r, np.array([1, 2]), np.ones((2, 4), np.float32))
    tab[[1, 2]] = 1.0
    ro = connect(server, tenant="srv", readonly=True)
    a = PoolAllocator(ro)
    assert a.readonly
    r2 = a.domain("embedding-mirror").alloc("rows", shape=tab.shape,
                                            dtype="float32")   # a reopen
    np.testing.assert_array_equal(NmpQueue(ro).gather(r2, np.arange(16)),
                                  tab)
    for attempt in (
            lambda: a.domain("embedding-mirror").alloc(
                "other", shape=(4,), dtype="float32"),
            lambda: a.free_domain("embedding-mirror"),
            lambda: ro.write(r2.off, np.zeros(4, np.uint8)),
            lambda: ro.alloc_region("x", "y", (4,), "uint8"),
            lambda: NmpQueue(ro).row_update(r2, np.array([0]),
                                            np.zeros((1, 4), np.float32))):
        with pytest.raises(TenantIsolationError):
            attempt()
    reader = open_ring(ro, readonly=True)
    assert reader.committed_steps() == [0]
    got = reader.committed_after(-1)
    np.testing.assert_array_equal(got[0][0], [1, 2])
    with pytest.raises(TenantIsolationError):
        reader.gc(1)


# -- bad frames ----------------------------------------------------------------

def _raw_connect(srv):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(10.0)
    s.connect(srv.addr[5:])
    return s


@pytest.mark.parametrize("case", ["oversized", "truncated", "garbage",
                                  "before_hello"])
def test_bad_frames_get_typed_errors(server, case):
    """An absurd length prefix and a garbage header are typed WireErrors,
    an op before hello a TenantIsolationError, EOF mid-frame a dropped
    connection; the node goes on serving new connections."""
    s = _raw_connect(server)
    if case == "oversized":
        s.sendall(struct.pack("<I", (1 << 30) + 1))
        want = "WireError"
    elif case == "truncated":
        s.sendall(struct.pack("<I", 64) + b"\x00\x01")   # promise 64, send 2
        want = None
    elif case == "garbage":
        body = b"\xde\xad\xbe\xef"
        s.sendall(struct.pack("<I", 4 + len(body)) + struct.pack("<I", 4)
                  + body)
        want = "WireError"
    else:
        send_frame(s, {"op": "read", "off": 0, "nbytes": 8, "tag": "r"})
        want = "TenantIsolationError"
    if want is not None:
        hdr, _ = recv_frame(s)
        assert hdr["ok"] is False and hdr["kind"] == want
    s.close()
    assert connect(server).capacity > 0


def test_connection_refused_is_typed(tmp_path):
    with pytest.raises(PoolConnectionError):
        RemotePool(f"unix:{tmp_path}/nobody.sock", timeout=5.0)


def test_unix_addr_fallback_directory_removed_at_exit(tmp_path):
    """A socket path too long for a unix socket goes to a fresh directory
    under TMPDIR, which is gone, socket and all, once the caller exits; a
    short one stays where it was asked for."""
    tmp = tmp_path / "t"
    tmp.mkdir()
    code = ("import socket\n"
            "from repro_torch.pool.server import unix_addr\n"
            f"print(unix_addr({str(tmp_path)!r}))\n"
            "addr = unix_addr('/' + 'x' * 120)\n"
            "socket.socket(socket.AF_UNIX).bind(addr[5:])\n"
            "print(addr)\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": src,
                            "TMPDIR": str(tmp)})
    assert r.returncode == 0, r.stderr
    short, long_ = r.stdout.split()
    assert short == f"unix:{tmp_path}/pool.sock"
    assert long_.startswith(f"unix:{tmp}/pool-")
    assert os.listdir(tmp) == []


def test_server_restart_mid_op(tmp_path, rng):
    img = str(tmp_path / "pool.img")
    srv = PoolServer(PmemPool(img, 1 << 18),
                     f"unix:{tmp_path}/pool.sock").start()
    dev = connect(srv, tenant="t")
    r = PoolAllocator(dev).domain("d").alloc("x", shape=(32,),
                                             dtype="float32")
    v = rng.standard_normal(32).astype(np.float32)
    r.write_array(v)
    r.persist(point="p")
    srv.shutdown(close_device=True)         # the node dies mid-session
    with pytest.raises(PoolConnectionError):
        r.read_array()
    srv2 = PoolServer(PmemPool.open(img), f"unix:{tmp_path}/pool.sock").start()
    try:
        r2 = PoolAllocator(connect(srv2, tenant="t")).domain("d").get("x")
        np.testing.assert_array_equal(r2.read_array(), v)
    finally:
        srv2.shutdown(close_device=True)


def test_concurrent_tenants_hammer(server):
    errs = []

    def work(name):
        try:
            dev = connect(server, tenant=name)
            r = PoolAllocator(dev).domain("d").alloc(
                "x", shape=(128,), dtype="float32")
            for i in range(20):
                v = np.full(128, float(i), np.float32)
                r.write_array(v)
                r.persist(point="p")
                np.testing.assert_array_equal(r.read_array(), v)
            dev.close()
        except Exception as e:              # surfaced in the main thread
            errs.append((name, e))

    threads = [threading.Thread(target=work, args=(f"t{i}",))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs


# -- the fused undo append: old rows never cross the link ----------------------

def test_fused_undo_append_keeps_old_rows_off_link(server, rng):
    dev = connect(server, tenant="fused")
    a = PoolAllocator(dev)
    tab = rng.standard_normal((256, 16)).astype(np.float32)
    mirror = a.domain("m").alloc("rows", shape=tab.shape, dtype="float32")
    mirror.write_array(tab)
    mirror.persist(point="load")
    ring = UndoRing(a, max_logs=4, compress=COMPRESS)
    idx = np.unique(rng.integers(0, 256, 64))
    new0 = rng.standard_normal((idx.size, 16)).astype(np.float32)
    ring.log_and_apply(0, mirror, idx, new0)        # warmup: ring creation
    dev.reset_metrics()
    new1 = rng.standard_normal((idx.size, 16)).astype(np.float32)
    info = ring.log_and_apply(1, mirror, idx, new1)
    m = dev.metrics
    assert m.link_bytes() <= idx.nbytes + new1.nbytes + 1024
    assert m.media_bytes("undo_snapshot") == idx.size * 16 * 4
    assert m.media_bytes("undo") >= info["stored"]
    assert m.media_bytes() > m.link_bytes()
    got_idx, got_rows, _ = ring.read(1)
    np.testing.assert_array_equal(got_idx, idx)
    np.testing.assert_array_equal(got_rows, new0)
    np.testing.assert_array_equal(mirror.read_array()[idx], new1)


def test_manager_tier_e_link_bytes_bounded(tmp_path, rng):
    """A remote tier-E step (fused op, manifest, GC) stays within idx +
    new_rows + 4 KB of link bytes; the media keep the undo payloads."""
    srv = PoolServer(DramPool(1 << 22), f"unix:{tmp_path}/pool.sock").start()
    try:
        cc = CheckpointConfig(directory=str(tmp_path / "ck"),
                              dense_interval=0, pool_backend="remote",
                              pool_addr=srv.addr, pool_tenant="trainer",
                              pool_compress=COMPRESS)
        cfg = get_arch("tinyllama-1.1b", smoke=True).model
        st0 = train_loop.init_state(cfg, TrainConfig(checkpoint=cc), "cpu")
        mgr = CheckpointManager(cfg, cc, embed_init=st0["embed"])
        nrows, d = mgr.mirror_region.shape
        idx = np.unique(rng.integers(0, nrows, 32)).astype(np.int64)
        new = rng.standard_normal((idx.size, d)).astype(np.float32)
        mgr._do_tier_e(0, idx, new)                 # warmup (ring creation)
        mgr.pool.reset_metrics()
        for step in (1, 2, 3):
            mgr._do_tier_e(step, idx, new)
        m = mgr.pool.metrics
        assert m.link_bytes() <= 3 * (idx.nbytes + new.nbytes + 4096)
        assert m.media_bytes("undo_snapshot") == 3 * idx.size * d * 4
        assert m.media_bytes() > 2 * m.link_bytes()
        assert mgr.stats["undo_stored_bytes"] <= mgr.stats["undo_raw_bytes"]
        mgr.close()
    finally:
        srv.shutdown(close_device=True)


def _ring_with_steps(dev, n, max_logs):
    mirror = PoolAllocator(dev).domain("m").alloc("rows", shape=(64, 8),
                                                  dtype="float32")
    ring = UndoRing(PoolAllocator(dev), max_logs=max_logs, compress=COMPRESS)
    for s in range(n):
        ring.log_and_apply(s, mirror, np.arange(4) + s,
                           np.full((4, 8), float(s), np.float32))
    return ring


def _count_requests(dev):
    calls = []
    orig = dev._request

    def counting(hdr, body=b""):
        calls.append(hdr["op"])
        return orig(hdr, body)

    dev._request = counting
    return calls, lambda: setattr(dev, "_request", orig)


def test_committed_scan_and_gc_round_trips(server):
    """The committed-set scan is ONE round trip, and GC ONE batched
    slot_clear however many slots expired (none when nothing did); a fresh
    attach rebuilds its liveness map with one scan first."""
    dev = connect(server, tenant="scan")
    ring = _ring_with_steps(dev, 20, max_logs=24)
    calls, restore = _count_requests(dev)
    try:
        assert ring.committed_steps() == list(range(20))
        assert calls == ["nmp"], calls
        calls.clear()
        ring.gc(keep_from=19)                # 19 expired entries, 1 RTT
        assert calls == ["nmp"], calls
        calls.clear()
        ring.gc(keep_from=19)                # nothing expired: no wire op
        assert calls == [], calls
    finally:
        restore()
    assert ring.committed_steps() == [19]
    ring2 = UndoRing(PoolAllocator(dev), max_logs=24, compress=COMPRESS)
    calls, restore = _count_requests(dev)
    try:
        ring2.gc(keep_from=20)
        assert calls == ["nmp", "nmp"], calls
    finally:
        restore()
    assert ring2.committed_steps() == []


# -- tcp auth -------------------------------------------------------------------

@pytest.fixture
def secure_tcp_server():
    srv = PoolServer(DramPool(1 << 18), "tcp:127.0.0.1:0",
                     secret="hunter2").start()
    yield srv
    srv.shutdown(close_device=True)


def test_tcp_auth_good_secret_round_trips(secure_tcp_server, rng,
                                          monkeypatch):
    """The right secret, given or from the environment (POOL.json never
    holds it), admits the tenant; the connection then behaves as usual."""
    dev = RemotePool(secure_tcp_server.addr, tenant="t", timeout=20.0,
                     secret="hunter2")
    r = PoolAllocator(dev).domain("d").alloc("x", shape=(8, 4),
                                             dtype="float32")
    v = rng.standard_normal((8, 4)).astype(np.float32)
    r.write_array(v)
    r.persist(point="p")
    np.testing.assert_array_equal(r.read_array(), v)
    np.testing.assert_array_equal(NmpQueue(dev).gather(r, np.array([1, 3])),
                                  v[[1, 3]])
    dev.close()
    monkeypatch.setenv("REPRO_POOL_SECRET", "hunter2")
    dev = make_pool("remote", addr=secure_tcp_server.addr, tenant="t")
    assert PoolAllocator(dev).domain("d").get("nothing") is None
    dev.close()


@pytest.mark.parametrize("secret", ["wrong", None])
def test_tcp_auth_rejected(secure_tcp_server, monkeypatch, secret):
    monkeypatch.delenv("REPRO_POOL_SECRET", raising=False)
    with pytest.raises(PoolAuthError):
        RemotePool(secure_tcp_server.addr, tenant="t", timeout=20.0,
                   secret=secret)


def test_unix_socket_exempt_from_secret(tmp_path):
    srv = PoolServer(DramPool(1 << 18), f"unix:{tmp_path}/sec.sock",
                     secret="hunter2").start()
    try:
        dev = RemotePool(srv.addr, tenant="t", timeout=20.0)
        assert dev.capacity > 0
        dev.close()
    finally:
        srv.shutdown(close_device=True)


def test_auth_challenge_is_single_use_per_attempt(secure_tcp_server):
    _, target = parse_addr(secure_tcp_server.addr)
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.settimeout(20.0)
    s.connect(target)
    try:
        send_frame(s, {"op": "hello", "tenant": "a"})
        hdr, _ = recv_frame(s)
        assert hdr["kind"] == "PoolAuthError" and hdr["challenge"]
        proof = auth_proof("hunter2", hdr["challenge"], "someone-else")
        send_frame(s, {"op": "hello", "tenant": "a",
                       "challenge": hdr["challenge"], "auth": proof})
        hdr2, _ = recv_frame(s)
        assert not hdr2.get("ok") and hdr2["kind"] == "PoolAuthError"
        good = auth_proof("hunter2", hdr["challenge"], "a")
        send_frame(s, {"op": "hello", "tenant": "a",
                       "challenge": hdr["challenge"], "auth": good})
        hdr3, _ = recv_frame(s)
        assert not hdr3.get("ok") and hdr3["kind"] == "PoolAuthError"
    finally:
        s.close()


# -- each package's client against the other's server ---------------------------

def _canon(x):
    """A comparable, bit-exact form of an op's result."""
    if isinstance(x, np.ndarray):
        return ("nd", str(x.dtype), x.shape, np.ascontiguousarray(x).tobytes())
    if isinstance(x, (bytes, bytearray, memoryview)):
        return ("b", bytes(x))
    if isinstance(x, dict):
        return ("d", tuple(sorted((k, _canon(v)) for k, v in x.items())))
    if isinstance(x, (list, tuple)):
        return ("l", tuple(_canon(v) for v in x))
    return ("v", x)


def _wire_script(pkg, addr, tenant, wire):
    """Every data and nmp op through one package's client. Returns the
    results and the link counters the node attributed to the tenant."""
    port = pkg == "port"
    Dev, Alloc, Q, Ring = ((RemotePool, PoolAllocator, NmpQueue, UndoRing)
                           if port else (R.RemotePool, R.PoolAllocator,
                                         R.NmpQueue, RUndoRing))
    rng = np.random.default_rng(0)
    dev = Dev(addr, tenant=tenant, timeout=20.0, wire=wire)
    assert dev.wire == wire
    a = Alloc(dev)
    out = []
    tab = rng.standard_normal((4, 64, 8)).astype(np.float32)
    stacked = a.domain("emb").alloc("stk", shape=tab.shape, dtype="float32")
    stacked.write_array(tab)
    flat = a.domain("emb").alloc("t", shape=(256, 8), dtype="float32")
    dev.write(flat.off, tab.reshape(-1, 8))
    dev.persist(flat.off, flat.nbytes, point="p")
    out.append(bytes(dev.read(flat.off, 64)))
    out.append(bytes(dev.read_async(flat.off + 64, 64).result()))
    out += [bytes(b) for b in dev.read_batch([(flat.off, 16),
                                              (flat.off + 32, 16)])]
    dev.write_async(flat.off, np.arange(4, dtype=np.float32)).result()
    out.append(bytes(dev.view(flat.off, 32)))
    q = Q(dev)
    idx = rng.integers(0, 256, 20)
    out.append(q.gather(flat, idx))
    bags = rng.integers(0, 64, (5, 4, 3))
    if port:
        out.append(q.bag_gather(stacked, bags))
    else:
        out.append(q.bag_gather(stacked, bags,
                                offsets=np.arange(4)[None, :, None] * 64))
    out.append(q.bag_gather(flat, rng.integers(0, 256, (6, 3)),
                            combine="mean"))
    out.append(q.undo_snapshot(flat, idx[:5]))
    q.row_update(flat, idx[:3], rng.standard_normal((3, 8))
                 .astype(np.float32), point="apply")
    q.scatter_add(flat, np.array([1, 1, 2]), np.ones((3, 8), np.float32),
                  point="apply")
    out.append(flat.read_array())
    ring = Ring(a, max_logs=4, compress=COMPRESS)
    uniq = np.unique(idx)
    for step in range(3):
        out.append(ring.log_and_apply(
            step, flat, uniq, np.full((uniq.size, 8), float(step),
                                      np.float32)))
    out.append(ring.committed_steps())
    out.append(ring.read(1))
    ring.gc(2)
    out.append(ring.committed_steps())
    blob_region = a.domain("dense").alloc("slot0", shape=(8192,),
                                          dtype="uint8")
    payload = np.tile(np.arange(100, dtype=np.uint8), 30).tobytes()
    stored = q.blob_put(blob_region, payload, compress="zlib")
    out += [stored, bytes(dev.read(blob_region.off, stored))]
    image = q.region_export(flat, compress="zlib")
    dst = a.domain("emb").alloc("copy", shape=(256, 8), dtype="float32")
    q.region_import(dst, image)
    out += [image, dst.read_array()]
    out += dev.nmp_batch([("gather", flat, {"idx": idx[:4]}),
                          ("undo_snapshot", flat, {"idx": idx[:2]})])
    link = {k: (s.ops, s.nbytes) for k, s in dev.metrics.link.items()}
    dev.close()
    return [_canon(x) for x in out], link


@pytest.mark.parametrize("wire", [1, 2, 3])
@pytest.mark.parametrize("direction", ["port-client", "jax-client"])
def test_cross_wire(tmp_path, direction, wire):
    """One package's client against the other package's node, each pinned
    to ``wire``: every data and nmp op (gathers, stacked and mean bags,
    the undo snapshot, row update, scatter-add, the fused undo append and
    its scan and GC, blob put, region export and import, a batch frame)
    gives the results, bit for bit, and the link bytes that the node's own
    package's client gets."""
    client, node = (("port", "jax") if direction == "port-client"
                    else ("jax", "port"))
    Server, Pool = ((R.PoolServer, R.DramPool) if node == "jax"
                    else (PoolServer, DramPool))
    srv = Server(Pool(1 << 20), f"unix:{tmp_path}/x.sock", wire=wire).start()
    try:
        got, got_link = _wire_script(client, srv.addr, "cross", wire)
        want, want_link = _wire_script(node, srv.addr, "native", wire)
    finally:
        srv.shutdown(close_device=True)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g == w, f"op result {i} differs"
    assert got_link == want_link and got_link["link_in"][1] > 0


@pytest.mark.parametrize("node", ["port", "jax"])
def test_split_read_and_write_beyond_the_frame_cap(tmp_path, monkeypatch,
                                                   node, rng):
    """A read and a write of more than the frame cap's worth (both
    packages' caps shrunk to 1 MiB for speed): the port's client splits
    them into frames of the same format that either node accepts, while a
    single oversized frame is still refused on both ends."""
    cap = 1 << 20
    monkeypatch.setattr(protocol, "MAX_FRAME", cap)
    monkeypatch.setattr(rproto, "MAX_FRAME", cap)
    Server, Pool = ((R.PoolServer, R.DramPool) if node == "jax"
                    else (PoolServer, DramPool))
    srv = Server(Pool(1 << 20), f"unix:{tmp_path}/s.sock").start()
    try:
        for wire in (1, 3):
            dev = RemotePool(srv.addr, tenant=f"w{wire}", timeout=20.0,
                             wire=wire)
            r = PoolAllocator(dev).domain("m").alloc(
                "rows", shape=(3 * cap // 32 + 5, 8), dtype="float32")
            v = rng.standard_normal(r.shape).astype(np.float32)
            r.write_array(v)
            assert dev.frames_split == -(-r.nbytes // (cap // 16))
            np.testing.assert_array_equal(r.view_array(), v)
            np.testing.assert_array_equal(r.read_array(), v)
            assert bytes(dev.read_async(r.off, r.nbytes).result()) == \
                v.tobytes()
            assert dev.frames_split == 4 * -(-r.nbytes // (cap // 16))
            dev.close()
        # one frame above the cap: refused by the client that packs it...
        rdev = R.RemotePool(srv.addr, tenant="w1", timeout=20.0)
        with pytest.raises(R.WireError, match="too large"):
            rdev.write(r.off, v)
        rdev.close()
        # ...and by the node, whatever a client sends
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(10.0)
        s.connect(srv.addr[5:])
        s.sendall(struct.pack("<I", cap + 1))
        hdr, _ = recv_frame(s)
        assert hdr["kind"] == "WireError"
        s.close()
    finally:
        srv.shutdown(close_device=True)


# -- the trainer-death drill -----------------------------------------------------

def _setup(ck, arch, **kw):
    cc = CheckpointConfig(directory=ck, dense_interval=1, **kw)
    tc = TrainConfig(embed_learning_rate=0.05, checkpoint=cc)
    cfg = get_arch(arch, smoke=True).model
    return cfg, tc, cc, make_batches(cfg, 4, 16, seed=3, device="cpu")


def _train(cfg, tc, data, steps, **kw):
    return train_loop.train(cfg, tc, data, steps, relaxed=True, device="cpu",
                            **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_death_recovers_bitwise(tmp_path, arch):
    """The port's trainer checkpoints 5 steps into the port's node and its
    socket vanishes without a close (trainer death): recovery over a fresh
    connection (POOL.json) gives the mirror of the same run on a pmem pool
    bit for bit, and the resumed losses are the uninterrupted run's."""
    cfg, tc, pc, data = _setup(str(tmp_path / "pm"), arch,
                               pool_backend="pmem")
    _, full = _train(cfg, tc, data, 8)
    mgr = CheckpointManager(cfg, pc, embed_init=train_loop.init_state(
        cfg, tc, "cpu")["embed"])
    _train(cfg, tc, data, 5, state=train_loop.init_state(cfg, tc, "cpu"),
           ckpt_manager=mgr)
    want = np.array(mgr.mirror_rows)
    mgr.close()
    srv = PoolServer(PmemPool(str(tmp_path / "node.img"), 1 << 22),
                     f"unix:{tmp_path}/pool.sock").start()
    try:
        ck = str(tmp_path / "ck")
        cfg, tc, cc, data = _setup(ck, arch, pool_backend="remote",
                                   pool_addr=srv.addr, pool_tenant="trainer")
        st0 = train_loop.init_state(cfg, tc, "cpu")
        mgr = CheckpointManager(cfg, cc, embed_init=st0["embed"])
        _train(cfg, tc, data, 5, state=st0, ckpt_manager=mgr)
        mgr.pool._sock.close()              # the socket just vanishes
        mgr.pool.closed = True
        rec = recovery.recover(ck)
        assert rec.mirror_step == 4 and rec.dense_step == 4
        np.testing.assert_array_equal(rec.embed_rows, want)
        st, resume = recovery.resume_train_state(
            rec, train_loop.init_state(cfg, tc, "cpu"))
        assert resume == 5
        # resume as the CLI does: a manager on the recovered connection
        mgr = CheckpointManager(cfg, cc, pool=rec.pool)
        mgr.init_mirror(st["embed"], step=rec.mirror_step)
        st, tail = _train(cfg, tc, data, 3, state=st, start_step=resume,
                          ckpt_manager=mgr)
        np.testing.assert_allclose(tail, full[5:], rtol=RESUME_TOL,
                                   atol=RESUME_TOL)
        assert mgr.ring.committed_steps()[-1] == 7
        mgr.close()
    finally:
        srv.shutdown(close_device=True)


def test_port_recovers_jax_trainer_from_jax_node(tmp_path):
    """A checkpoint the JAX trainer wrote into the JAX package's node
    (then its socket vanished) recovers through the port's client to the
    mirror, dense leaves and steps the JAX package recovers."""
    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro.configs.base import CheckpointConfig as JaxCheckpointConfig
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.core.checkpoint import recovery as jrecovery
    from repro.core.checkpoint.manager import CheckpointManager as JaxManager
    from repro.data.synthetic import make_batches as jax_make_batches
    from repro.training import train_loop as jtl

    srv = R.PoolServer(R.PmemPool(str(tmp_path / "node.img"), 1 << 22),
                       f"unix:{tmp_path}/pool.sock").start()
    try:
        ck = str(tmp_path / "ck")
        jcfg = jax_get_arch("dlrm-rm1", smoke=True).model
        cc = JaxCheckpointConfig(directory=ck, dense_interval=1,
                                 pool_backend="remote", pool_addr=srv.addr,
                                 pool_tenant="jax-trainer")
        jtc = JaxTrainConfig(embed_learning_rate=0.05, checkpoint=cc)
        st0 = jtl.make_step_fns(jcfg, jtc)[0](jax.random.PRNGKey(0))
        mgr = JaxManager(jcfg, cc, embed_init=st0["embed"])
        jtl.train(jcfg, jtc, jax_make_batches(jcfg, 4, 16, seed=3), 3,
                  relaxed=True, state=st0, ckpt_manager=mgr)
        mgr.flush()
        mgr.pool._sock.close()
        mgr.pool.closed = True
        jrec = jrecovery.recover(ck)
        prec = recovery.recover(ck)
        try:
            assert prec.pool.backend == "remote"
            assert (prec.mirror_step, prec.dense_step) == \
                (jrec.mirror_step, jrec.dense_step) == (2, 2)
            assert prec.table_shape == tuple(jrec.table_shape)
            np.testing.assert_array_equal(prec.embed_rows, jrec.embed_rows)
            want = jax.tree_util.tree_leaves(jrec.dense)
            got = [x.float().numpy() if x.dtype.is_floating_point else
                   x.numpy() for x in _tensor_leaves(prec.dense)]
            assert len(got) == len(want)
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(
                    g, np.asarray(w, dtype=g.dtype))
        finally:
            jrec.pool.close()
            prec.pool.close()
    finally:
        srv.shutdown(close_device=True)


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return [tree]


def test_pool_json_names_the_node(tmp_path):
    """POOL.json carries the JAX package's keys and values for a remote
    pool (never the secret), so either package reconnects to the node."""
    import json
    srv = PoolServer(DramPool(1 << 22), f"unix:{tmp_path}/pool.sock").start()
    try:
        ck = str(tmp_path / "ck")
        cfg, tc, cc, _ = _setup(ck, "dlrm-rm1", pool_backend="remote",
                                pool_addr=srv.addr, pool_tenant="t1",
                                pool_quota=1 << 30, pool_secret="s3")
        mgr = CheckpointManager(cfg, cc, embed_init=train_loop.init_state(
            cfg, tc, "cpu")["embed"])
        mgr.close()
        with open(os.path.join(ck, "POOL.json")) as f:
            info = json.load(f)
        assert info == {"backend": "remote", "addr": srv.addr, "tenant": "t1",
                        "quota": 1 << 30, "manifest_quorum": False,
                        "ckpt_replica": -1}
        rdev = R.RemotePool(info["addr"], tenant=info["tenant"],
                            quota=info["quota"], timeout=20.0)
        assert R.PoolAllocator(rdev).domain("embedding-mirror").get("rows") \
            is not None
        rdev.close()
    finally:
        srv.shutdown(close_device=True)
