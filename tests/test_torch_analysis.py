"""The port's crash-consistency checker and invariant lints
(``repro_torch.analysis``) against the JAX package's (``repro.analysis``).

Three layers, as ``tests/test_analysis.py`` has them:

  * the same event sequences, through both packages' ``ShadowTracker``s and
    their ``CheckedPool``s over the dram, pmem and remote pools, raise the
    same typed ``OrderingViolation`` (rules U, C, P and F), or none;
  * the port's linter is clean on ``src/repro_torch``, cross-referencing
    the port's own drills only, and on the unchanged seeded-bad fixture it
    gives the JAX linter's findings line for line;
  * arming drills for every named barrier of the port that the dead-point
    rule would otherwise flag, each firing the real point through the
    port's code path (the sharded drills over checked shard devices, so
    they double as the proof that the epoch publish and the open-time
    sweep are persist-clean under the checker).
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.analysis.checker as jck
import repro.pool as J
from repro.analysis import lint as jlint
from repro.pool import undo_codec as juc
from repro_torch.analysis import checker as pck
from repro_torch.analysis import lint
from repro_torch.analysis.checker import (CheckedPool, OrderingViolation,
                                          RecycledBufferError)
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.core.checkpoint.undo_log import UndoRing
from repro_torch.data.synthetic import make_batches
from repro_torch.pool import (DramPool, FaultEvent, FaultSchedule,
                              InjectedCrash, PmemPool, PoolAllocator,
                              PoolError, ShardedPool, make_pool, protocol)
from repro_torch.pool import undo_codec as uc
from repro_torch.pool.allocator import JsonRegion
from repro_torch.pool.remote import RemotePool
from repro_torch.pool.server import PoolServer
from repro_torch.pool.sharded import region_pieces
from repro_torch.training import train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT_SRC = os.path.join(SRC, "repro_torch")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "lint_bad.py")

PKGS = {
    "jax": SimpleNamespace(ck=jck, make_pool=J.make_pool,
                           Alloc=J.PoolAllocator, uc=juc, Server=J.PoolServer,
                           Dram=J.DramPool),
    "port": SimpleNamespace(ck=pck, make_pool=make_pool, Alloc=PoolAllocator,
                            uc=uc, Server=PoolServer, Dram=DramPool),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke drills run torch on one thread: tier-1 runs six files at
    once, and the smoke shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(P, fn):
    """The violation class's name fn raised through package P, or "ok"."""
    try:
        fn()
    except P.ck.OrderingViolation as e:
        return type(e).__name__
    return "ok"


# ---------------------------------------------------------------------------
# the tracker: the same events, the same verdict in both packages
# ---------------------------------------------------------------------------

A, B = ("d", "a"), ("d", "b")
SEQUENCES = {
    # the paper's two barriers in order: payload, then COMMIT
    "two_barrier_clean": ("ok", [
        ("note_alloc", A, 0x1000, 4096), ("note_write", 0x1000, 1024),
        ("note_persist", 0x1000, 0x1400, "undo-payload"),
        ("note_write", 0x1000 + 36, 4),
        ("note_persist", 0x1000 + 36, 0x1000 + 40, "undo-commit")]),
    "commit_before_payload": ("CommitBeforePayloadError", [
        ("note_alloc", A, 0x1000, 4096), ("note_write", 0x1000, 1024),
        ("note_write", 0x1000 + 36, 4),
        ("note_persist", 0x1000 + 36, 0x1000 + 40, "undo-commit")]),
    # rule C looks only inside the COMMIT's own region
    "commit_other_region_dirty": ("ok", [
        ("note_alloc", A, 0x1000, 4096), ("note_alloc", B, 0x2000, 4096),
        ("note_write", 0x2000, 64), ("note_write", 0x1000, 4),
        ("note_persist", 0x1000, 0x1004, "undo-commit")]),
    "unpersisted_read_after_crash": ("UnpersistedReadError", [
        ("note_alloc", A, 0x1000, 64), ("note_write", 0x1000, 64),
        ("note_crash",), ("note_read", 0x1000, 64)]),
    "persisted_read_after_crash": ("ok", [
        ("note_alloc", A, 0x1000, 64), ("note_write", 0x1000, 64),
        ("note_persist", 0x1000, 0x1040, "mirror-apply"), ("note_crash",),
        ("note_read", 0x1000, 64)]),
    "rewrite_after_crash": ("ok", [
        ("note_write", 0x1000, 64), ("note_crash",),
        ("note_write", 0x1000, 64), ("note_read", 0x1000, 64)]),
    "crash_window_outside": ("ok", [
        ("note_write", 0x0, 8), ("note_write", 0x100, 8),
        ("note_crash", (0x0, 0x80)), ("note_read", 0x100, 8)]),
    "crash_window_inside": ("UnpersistedReadError", [
        ("note_write", 0x0, 8), ("note_write", 0x100, 8),
        ("note_crash", (0x0, 0x80)), ("note_read", 0x0, 8)]),
    "write_after_publish": ("WriteAfterPublishError", [
        ("note_persist", 0x0, 0x40, "superblock"), ("note_write", 0x10, 4)]),
    "sibling_publish_unseals": ("ok", [
        ("note_persist", 0x0, 0x40, "superblock"),
        ("note_persist", 0x40, 0x80, "superblock"), ("note_write", 0x10, 4)]),
    "crash_unseals": ("ok", [
        ("note_persist", 0x0, 0x40, "manifest"), ("note_crash",),
        ("note_write", 0x10, 4)]),
    "use_after_free_read": ("UseAfterFreeError", [
        ("note_alloc", A, 0x1000, 64), ("note_free", A, 0x1000, 64),
        ("note_read", 0x1000, 8)]),
    "use_after_free_write": ("UseAfterFreeError", [
        ("note_alloc", A, 0x1000, 64), ("note_free", A, 0x1000, 64),
        ("note_write", 0x1010, 8)]),
    "use_after_free_persist": ("UseAfterFreeError", [
        ("note_alloc", A, 0x1000, 64), ("note_free", A, 0x1000, 64),
        ("note_persist", 0x1000, 0x1040, "mirror-apply")]),
    "realloc_after_free": ("ok", [
        ("note_alloc", A, 0x1000, 64), ("note_free", A, 0x1000, 64),
        ("note_alloc", B, 0x1000, 64), ("note_write", 0x1000, 8)]),
    "double_free": ("DoubleFreeError", [
        ("note_alloc", A, 0x1000, 64), ("note_free", A, 0x1000, 64),
        ("note_free", A, 0x1000, 64)]),
    "overlap": ("RegionOverlapError", [
        ("note_alloc", "a", 0, 100), ("note_alloc", "b", 50, 150)]),
    "same_key_moves": ("ok", [
        ("note_alloc", "a", 0, 100), ("note_alloc", "a", 50, 150)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_tracker_sequences_match_the_reference(name):
    """Each event sequence gives the same verdict through both trackers, and
    the expected one."""
    want, events = SEQUENCES[name]
    got = {}
    for pkg, P in PKGS.items():
        t = P.ck.ShadowTracker(pkg)

        def drive(t=t):
            for method, *args in events:
                getattr(t, method)(*args)
        got[pkg] = _outcome(P, drive)
    assert got == {"jax": want, "port": want}


def test_recycled_buffer_error_is_the_checkers():
    """One class object, from the wire module and the checker: an ordering
    violation, never a ``PoolError`` (failover code catches those)."""
    assert protocol.RecycledBufferError is RecycledBufferError
    assert issubclass(RecycledBufferError, OrderingViolation)
    assert not issubclass(RecycledBufferError, PoolError)


# ---------------------------------------------------------------------------
# the wrapper over the port's devices, against the JAX package's
# ---------------------------------------------------------------------------


def _ring(P, dev):
    return P.Alloc(dev).domain("d").alloc("ring", shape=(4096,),
                                          dtype="uint8")


def _slot(P):
    buf, _, _ = P.uc.pack_slot(1, np.arange(4, dtype=np.int64),
                               np.ones((4, 8), np.float32), None,
                               mode="none", slot_bytes=1024)
    return buf


def _clean_two_barrier(P, dev):
    r = _ring(P, dev)
    P.uc.write_slot(dev, r.off, _slot(P))
    dev.crash()
    hdr = P.uc.parse_header(bytes(dev.read(r.off, P.uc.HDR.size)), 1024)
    assert hdr is not None and hdr[0] == 1


def _commit_before_payload(P, dev):
    r = _ring(P, dev)
    dev.write(r.off, _slot(P))                   # payload never persisted
    dev.write(r.off + P.uc.COMMIT_OFF, P.uc.COMMIT_SET)
    dev.persist(r.off + P.uc.COMMIT_OFF, 4, point="undo-commit")


def _unpersisted_read(P, dev):
    r = P.Alloc(dev).domain("d").alloc("x", shape=(64,), dtype="uint8")
    dev.write(r.off, b"\x7f" * 64)              # no persist
    dev.crash()
    dev.read(r.off, 64)


def _write_after_publish(P, dev):
    dom = P.Alloc(dev).domain("d")
    dom.alloc("a", shape=(128,), dtype="uint8")
    assert len(dev.tracker.sealed) == 1         # the superblock slot
    lo, _ = dev.tracker.sealed[0]
    try:
        dev.write(lo, b"\x00")
    finally:
        # the sibling publish supersedes the seal: the old slot is spare
        sealed = dev.tracker.sealed[0]
        dom.alloc("b", shape=(128,), dtype="uint8")
        assert len(dev.tracker.sealed) == 1
        assert dev.tracker.sealed[0] != sealed


def _use_after_free(P, dev):
    dom = P.Alloc(dev).domain("d")
    r = dom.alloc("x", shape=(256,), dtype="uint8")
    dev.write(r.off, b"z" * 256)
    dev.persist(r.off, 256)
    dom.free_region("x")
    dev.read(r.off, 16)                         # a stale handle


DEVICE_CASES = {
    "clean_two_barrier-dram": ("dram", _clean_two_barrier, "ok"),
    "clean_two_barrier-pmem": ("pmem", _clean_two_barrier, "ok"),
    "commit_before_payload-dram": ("dram", _commit_before_payload,
                                   "CommitBeforePayloadError"),
    "commit_before_payload-pmem": ("pmem", _commit_before_payload,
                                   "CommitBeforePayloadError"),
    "unpersisted_read-dram": ("dram", _unpersisted_read,
                              "UnpersistedReadError"),
    "unpersisted_read-pmem": ("pmem", _unpersisted_read,
                              "UnpersistedReadError"),
    "write_after_publish-dram": ("dram", _write_after_publish,
                                 "WriteAfterPublishError"),
    "use_after_free-dram": ("dram", _use_after_free, "UseAfterFreeError"),
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_checked_device_matches_the_reference(tmp_path, case):
    """The same sequence on each package's pool, wrapped by its own checker
    (``make_pool(..., check=True)``), gives the same verdict."""
    backend, fn, want = DEVICE_CASES[case]
    got = {}
    for pkg, P in PKGS.items():
        dev = P.make_pool(backend, path=str(tmp_path / f"{pkg}.img"),
                          capacity=1 << 20, check=True)
        assert type(dev).__name__ == "CheckedPool"
        got[pkg] = _outcome(P, lambda P=P, dev=dev: fn(P, dev))
        dev.close()
    assert got == {"jax": want, "port": want}


def _remote_flow(P, dev):
    r = P.Alloc(dev).domain("d").alloc("x", shape=(64,), dtype="uint8")
    dev.write(r.off, b"a" * 64)
    dev.persist(r.off, 64)
    dev.crash()                                 # node power-cycle
    assert bytes(dev.read(r.off, 64)) == b"a" * 64
    dev.write(r.off, b"b" * 64)                 # volatile on the node
    dev.crash()
    dev.read(r.off, 64)


def test_checked_remote_matches_the_reference(tmp_path):
    """The wrapper over each package's remote pool (its own node): clean
    across a node power-cycle, then rule U on a write the node never
    flushed."""
    got = {}
    for pkg, P in PKGS.items():
        srv = P.Server(P.Dram(1 << 20), f"unix:{tmp_path}/{pkg}.sock").start()
        try:
            dev = P.make_pool("remote", addr=srv.addr, check=True)
            assert type(dev).__name__ == "CheckedPool"
            got[pkg] = _outcome(P, lambda P=P, dev=dev: _remote_flow(P, dev))
            dev.close()
        finally:
            srv.shutdown(close_device=True)
    assert got == {"jax": "UnpersistedReadError",
                   "port": "UnpersistedReadError"}


def test_checker_off_by_default(monkeypatch):
    monkeypatch.delenv("REPRO_POOL_CHECK", raising=False)
    dev = make_pool("dram", capacity=1 << 16)
    assert isinstance(dev, DramPool)            # no cost on the default path
    assert isinstance(make_pool("dram", capacity=1 << 16, check=True),
                      CheckedPool)
    monkeypatch.setenv("REPRO_POOL_CHECK", "1")
    dev = make_pool("dram", capacity=1 << 16)
    assert isinstance(dev, CheckedPool) and isinstance(dev.inner, DramPool)
    # an explicit opt-out wins
    assert isinstance(make_pool("dram", capacity=1 << 16, check=False),
                      DramPool)


def test_refresh_capacity_sees_foreign_growth(tmp_path):
    """The ``capacity`` op's client stub (the reference's R2a finding): a
    client refreshes its cached gauge after another connection grew the
    shared device."""
    srv = PoolServer(DramPool(1 << 20), f"unix:{tmp_path}/c.sock").start()
    try:
        a, b = RemotePool(srv.addr), RemotePool(srv.addr)
        cap0 = a.capacity
        b.ensure(cap0 + (1 << 20))
        assert a.capacity == cap0               # the cached gauge is stale
        got = a.refresh_capacity()
        assert got >= cap0 + (1 << 20)
        assert a.capacity == got == srv.device.capacity
        a.close()
        b.close()
    finally:
        srv.shutdown(close_device=True)


def test_region_import_pieces_are_tracked_by_their_own_spans(tmp_path,
                                                              monkeypatch,
                                                              rng):
    """A region above the split size moves as one ``region_import`` a
    piece; the checked destination shard records each piece's own span,
    in order, and the copy is bitwise and persist-clean."""
    monkeypatch.setattr(protocol, "MAX_FRAME", 1 << 20)   # 64 KiB pieces
    servers = [PoolServer(DramPool(1 << 21), f"unix:{tmp_path}/n{i}.sock")
               .start() for i in range(2)]
    try:
        shards = [CheckedPool(RemotePool(s.addr)) for s in servers]
        pool = ShardedPool(shards, pin={"embedding-mirror": 0})
        tab = rng.standard_normal((5000, 8)).astype(np.float32)
        r = PoolAllocator(pool).domain("embedding-mirror").alloc(
            "rows", shape=tab.shape, dtype="float32")
        r.write_array(tab)
        r.persist(point="mirror-load")
        spans = []
        note_write = shards[1].tracker.note_write

        def record(off, nbytes, what="write"):
            if what == "nmp[region_import]":
                spans.append((off, nbytes))
            note_write(off, nbytes, what=what)
        shards[1].tracker.note_write = record
        info = pool.replicate_domain("embedding-mirror", 1, compress="none",
                                     watermark=1)
        rep = pool.shards[1].list_regions(info["replica"])["rows"]
        got = pool.shards[1].device.read(int(rep["off"]), int(rep["nbytes"]))
        np.testing.assert_array_equal(
            np.asarray(got).view(np.float32).reshape(tab.shape), tab)
        dst = pool.shards[1].region(info["replica"], "rows", rep)
        assert len(spans) == 3 and spans == [
            (p.off - dst.off + int(rep["off"]), p.nbytes)
            for p in region_pieces(dst)]
        pool.close()
    finally:
        for s in servers:
            s.shutdown(close_device=True)


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------


def test_lint_clean_on_the_port():
    findings = lint.run([PORT_SRC])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_lint_reads_only_the_ports_drills():
    files = lint._drill_files(PORT_SRC)
    names = {os.path.basename(f) for f in files}
    assert "pool_soak.py" in names and "test_torch_analysis.py" in names
    assert "test_analysis.py" not in names and "lint_bad.py" not in names
    assert all(os.path.basename(f).startswith("test_torch_")
               or os.sep + "examples" + os.sep in f for f in files)


def test_lint_fixture_findings_match_the_reference():
    """File-local mode on the unchanged fixture: the same five findings,
    rule for rule and line for line, in both packages."""
    port = {(f.rule, f.line) for f in lint.run([FIXTURE])}
    ref = {(f.rule, f.line) for f in jlint.run([FIXTURE])}
    assert port == ref
    assert {r for r, _ in port} == {
        "R1a-typo-arm", "R1c-unregistered-point", "R2d-unknown-nmp-kind",
        "R3-lock-cycle", "R4-socket-under-lock"}
    assert len(port) == 5
    for f in lint.run([FIXTURE]):               # file:line diagnostics
        assert str(f).startswith(f"{f.path}:{f.line}: [{f.rule}]")


def test_lint_v3_codec_rule_clean_and_loud(monkeypatch):
    findings = []
    lint._rule_v3(findings)
    assert findings == [], findings
    monkeypatch.setattr(protocol, "_V3_NMP_KINDS",
                        protocol._V3_NMP_KINDS + ("ghost_kind",))
    findings = []
    lint._rule_v3(findings)
    assert any(f.rule == "R5a-missing-v3-codec" and "ghost_kind" in f.msg
               for f in findings), findings


def test_lint_copy_rule_flags_unannotated_bytes(tmp_path):
    pdir = tmp_path / "pool"
    pdir.mkdir()
    bad = pdir / "server.py"
    bad.write_text(
        "def leak(mv, arr, segs):\n"
        "    a = bytes(mv)\n"
        "    b = arr.tobytes()\n"
        "    c = b\"\".join(segs)\n"
        "    # wire-copy: sanctioned staging copy\n"
        "    d = bytes(mv)\n"
        "    e = arr.tobytes()  # wire-copy: sanctioned inline\n"
        "    return a, b, c, d, e\n")
    findings = []
    lint._rule_copies([str(bad)], findings)
    assert [f.line for f in findings] == [2, 3, 4], findings
    assert all(f.rule == "R6-copy-on-data-path" for f in findings)
    other = tmp_path / "elsewhere.py"
    other.write_text("x = bytes(b'ab')\n")
    findings = []
    lint._rule_copies([str(other)], findings)
    assert findings == []


def test_lint_main_exit_codes(capsys):
    assert lint.main([PORT_SRC]) == 0
    assert lint.main([FIXTURE]) == 1
    assert "lint_bad.py:" in capsys.readouterr().out


def test_lint_entry_and_analysis_load_no_jax_and_no_reference():
    """``python -m repro_torch.analysis.lint src/repro_torch`` exits 0, and
    neither it nor ``import repro_torch.analysis`` loads jax or repro."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys\n"
         "import repro_torch.analysis\n"
         "sys.argv = ['lint', 'src/repro_torch']\n"
         "try:\n"
         "    runpy.run_module('repro_torch.analysis.lint', run_name='__main__')\n"
         "except SystemExit as e:\n"
         "    code = e.code\n"
         "bad = [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'repro', 'torch')]\n"
         "print('exit', code, 'bad', bad)\n"
         "sys.exit(code or (1 if bad else 0))"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": SRC}, capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "lint: clean" in r.stdout and "bad []" in r.stdout


# ---------------------------------------------------------------------------
# arming drills: migration and replication barriers, over checked shards
# ---------------------------------------------------------------------------


def _checked_sharded(nshards=2):
    return ShardedPool([CheckedPool(DramPool(1 << 20))
                        for _ in range(nshards)])


def _domain_bytes(pool, domain):
    return {name: bytes(pool.read(r.off, r.nbytes, tag="oracle"))
            for name, r in PoolAllocator(pool).domain(domain).regions().items()}


def _seed_mirror(pool, rng):
    tab = rng.standard_normal((64, 8)).astype(np.float32)
    mirror = PoolAllocator(pool).domain("embedding-mirror").alloc(
        "rows", shape=tab.shape, dtype="float32")
    mirror.write_array(tab)
    mirror.persist(point="mirror-load")
    return tab


@pytest.mark.parametrize("point",
                         ["migrate-alloc", "migrate-import", "migrate-gc"])
def test_migration_barrier_points_fire(point):
    """A crash at each per-region migration barrier interrupts the copy;
    the sweep reclaims the stranded side and the image is bitwise."""
    rng = np.random.default_rng(7)
    pool = _checked_sharded()
    _seed_mirror(pool, rng)
    src = pool.placement.place("embedding-mirror")
    oracle = _domain_bytes(pool, "embedding-mirror")
    pool.faults = FaultSchedule.crash_at(point)
    with pytest.raises(InjectedCrash):
        pool.migrate_domain("embedding-mirror", 1 - src)
    pool.faults = None
    pool.sweep_stale_domains()
    # gc fires after the flip; the copy barriers before it
    owner = 1 - src if point == "migrate-gc" else src
    assert pool.placement.place("embedding-mirror") == owner
    assert _domain_bytes(pool, "embedding-mirror") == oracle
    pool.close()


def test_migrate_sweep_point_fires():
    """A source copy stranded by a crash after the flip; the sweep's own
    free barrier crashes; the re-run sweep leaves one owner."""
    rng = np.random.default_rng(13)
    pool = _checked_sharded()
    _seed_mirror(pool, rng)
    src = pool.placement.place("embedding-mirror")
    oracle = _domain_bytes(pool, "embedding-mirror")
    pool.faults = FaultSchedule.crash_at("migrate.post-flip-pre-gc")
    with pytest.raises(InjectedCrash):
        pool.migrate_domain("embedding-mirror", 1 - src)
    pool.faults = FaultSchedule.crash_at("migrate-sweep")
    with pytest.raises(InjectedCrash):
        pool.sweep_stale_domains()
    pool.faults = None
    pool.sweep_stale_domains()
    assert "embedding-mirror" not in pool.shard_domains(src)
    assert pool.placement.place("embedding-mirror") == 1 - src
    assert _domain_bytes(pool, "embedding-mirror") == oracle
    pool.close()


@pytest.mark.parametrize("point", ["replica-alloc", "replica-import",
                                   "replica-watermark"])
def test_replica_barrier_points_fire(point):
    """A crash at each replica-refresh barrier, then a clean retry: the
    replica converges to the primary's bytes and the watermark lands."""
    rng = np.random.default_rng(11)
    pool = _checked_sharded()
    tab = _seed_mirror(pool, rng)
    dst = 1 - pool.placement.place("embedding-mirror")
    pool.faults = FaultSchedule.crash_at(point)
    with pytest.raises(InjectedCrash):
        pool.replicate_domain("embedding-mirror", dst, watermark=3)
    pool.faults = None
    info = pool.replicate_domain("embedding-mirror", dst, watermark=5)
    assert info["dst"] == dst and info["regions"] >= 1
    rep = pool.shards[dst].list_regions(info["replica"])
    assert "rows" in rep and "watermark" in rep
    got = pool.shards[dst].device.read(
        int(rep["rows"]["off"]), int(rep["rows"]["nbytes"]), tag="drill")
    np.testing.assert_array_equal(
        np.asarray(got).view(np.float32).reshape(tab.shape), tab)
    pool.close()


def _promoted_ctx(rng):
    """3 checked shards; the mirror and ring live on their placed shard,
    replicas of both refreshed onto a second: the promotion drills' start."""
    pool = _checked_sharded(3)
    _seed_mirror(pool, rng)
    a = PoolAllocator(pool)
    ring = UndoRing(a, max_logs=4, compress="zlib")
    idx = np.unique(rng.integers(0, 64, 12))
    new = rng.standard_normal((idx.size, 8)).astype(np.float32)
    ring.log_and_apply(0, a.domain("embedding-mirror").get("rows"), idx, new)
    src = pool.placement.place("embedding-mirror")
    dst = (src + 1) % 3
    pool.replicate_domain("embedding-mirror", dst, watermark=0)
    pool.replicate_domain("undo-log", dst, watermark=0)
    return pool, ring, src, dst


@pytest.mark.parametrize("point", ["promote.pre-copy", "promote-alloc",
                                   "promote.mid-copy", "promote-import",
                                   "promote.post-copy-pre-flip"])
def test_promotion_pre_flip_crash_leaves_placement_unmoved(point):
    """A crash anywhere before the promotion's flip leaves the domain routed
    at the source; the re-run moves the whole alias group in one epoch."""
    rng = np.random.default_rng(23)
    pool, _, src, dst = _promoted_ctx(rng)
    replica_rows = _domain_bytes(pool, "embedding-mirror@replica")["rows"]
    pool.faults = FaultSchedule.crash_at(point)
    with pytest.raises(InjectedCrash):
        pool.promote_replica("embedding-mirror")
    pool.faults = None
    assert pool.placement.place("embedding-mirror") == src
    assert pool.placement.place("undo-log") == src
    info = pool.promote_replica("embedding-mirror")
    assert set(info["promoted"]) == {"embedding-mirror", "undo-log"}
    assert pool.placement.place("embedding-mirror") == dst
    assert pool.placement.place("undo-log") == dst
    assert _domain_bytes(pool, "embedding-mirror")["rows"] == replica_rows
    pool.close()


def test_promotion_post_flip_crash_is_already_promoted():
    """A crash after the flip: the promoted copy is authoritative, and the
    open-time sweep reclaims the source's stale copies."""
    rng = np.random.default_rng(29)
    pool, _, src, dst = _promoted_ctx(rng)
    pool.faults = FaultSchedule.crash_at("promote.post-flip")
    with pytest.raises(InjectedCrash):
        pool.promote_replica("embedding-mirror")
    pool.faults = None
    assert pool.placement.place("embedding-mirror") == dst
    assert pool.placement.place("undo-log") == dst
    oracle = _domain_bytes(pool, "embedding-mirror")
    assert sorted(pool.sweep_stale_domains()) == [
        ("embedding-mirror", src), ("undo-log", src)]
    assert _domain_bytes(pool, "embedding-mirror") == oracle
    pool.close()


def test_promotion_gc_point_reclaims_stranded_shape():
    """A same-name region of an older shape stranded on the replica shard
    is freed at "promote-gc" (drilled), then the fresh copy lands."""
    rng = np.random.default_rng(31)
    pool, _, _, dst = _promoted_ctx(rng)
    pool.shards[dst].alloc_region("embedding-mirror", "rows", (8, 8),
                                  "float32", "promote-alloc")
    pool.faults = FaultSchedule.crash_at("promote-gc")
    with pytest.raises(InjectedCrash):
        pool.promote_replica("embedding-mirror")
    pool.faults = None
    info = pool.promote_replica("embedding-mirror")
    assert info["regions"] >= 2                 # rows + watermark (+ ring)
    got = _domain_bytes(pool, "embedding-mirror")
    assert got["rows"] == _domain_bytes(pool,
                                        "embedding-mirror@replica")["rows"]
    pool.close()


def test_replica_gc_point_fires_on_retired_source_region():
    """The source renames a region; the refresh frees the stale replica
    name at "replica-gc" (drilled) and the retry mirrors the source."""
    rng = np.random.default_rng(37)
    pool = _checked_sharded(2)
    _seed_mirror(pool, rng)
    dst = 1 - pool.placement.place("embedding-mirror")
    pool.replicate_domain("embedding-mirror", dst, watermark=0)
    dom = PoolAllocator(pool).domain("embedding-mirror")
    dom.free_region("rows")
    r2 = dom.alloc("rows2", shape=(32, 8), dtype="float32")
    r2.write_array(np.ones((32, 8), np.float32))
    r2.persist(point="mirror-load")
    pool.faults = FaultSchedule.crash_at("replica-gc")
    with pytest.raises(InjectedCrash):
        pool.replicate_domain("embedding-mirror", dst, watermark=1)
    pool.faults = None
    pool.replicate_domain("embedding-mirror", dst, watermark=1)
    rep = pool.shards[dst].list_regions("embedding-mirror@replica")
    assert set(rep) == {"rows2", "watermark"}
    pool.close()


def test_commit_ship_point_fires_and_slot_lands():
    """A crash at "replica.commit-ship", then a retry: the slot image lands
    in the replica ring at the same offset and is re-committed there (all
    bytes equal but the COMMIT word, which write_slot sets last)."""
    rng = np.random.default_rng(41)
    pool, ring, _, dst = _promoted_ctx(rng)
    name, slot_off, buf = ring.slot_image(0)
    pool.faults = FaultSchedule.crash_at("replica.commit-ship")
    with pytest.raises(InjectedCrash):
        pool.ship_slot("undo-log", name, slot_off, buf)
    pool.faults = None
    assert pool.ship_slot("undo-log", name, slot_off, buf) == len(buf)
    rep = pool.shards[dst].list_regions("undo-log@replica")
    got = bytes(pool.shards[dst].device.read(
        int(rep[name]["off"]) + slot_off, len(buf), tag="drill"))
    assert got[:uc.COMMIT_OFF] == buf[:uc.COMMIT_OFF]
    assert got[uc.HDR.size:] == buf[uc.HDR.size:]
    assert int.from_bytes(got[uc.COMMIT_OFF:uc.HDR.size], "little") != 0
    pool.close()


def test_manifest_witness_publish_is_ab_safe():
    """A crash at the "manifest-witness" publish leaves a sealed image
    electable (old or new, never torn); the retry converges."""
    pool = _checked_sharded(3)
    jr = JsonRegion.create(PoolAllocator(pool).domain("manifest@w1"),
                           "manifest")
    jr.write({"mirror_step": 1}, point="manifest-witness")
    pool.faults = FaultSchedule.crash_at("manifest-witness")
    with pytest.raises(InjectedCrash):
        jr.write({"mirror_step": 2}, point="manifest-witness")
    pool.faults = None
    assert (jr.read() or {}).get("mirror_step") in (1, 2)
    jr.write({"mirror_step": 2}, point="manifest-witness")
    assert (jr.read() or {}).get("mirror_step") == 2
    pool.close()


def test_epoch_publish_and_sweep_clean_under_checker(tmp_path):
    """A clean migration (copy, epoch publish, source gc) and the open-time
    sweep, every shard checked: any missing persist would raise here."""
    rng = np.random.default_rng(17)
    pool = _checked_sharded()
    sink_file = str(tmp_path / "placement.json")

    def sink(pm):
        with open(sink_file, "w") as f:
            json.dump(pm.to_json(), f)

    pool.epoch_sink = sink
    _seed_mirror(pool, rng)
    a = PoolAllocator(pool)
    ring = UndoRing(a, max_logs=4, compress="zlib")
    idx = np.unique(rng.integers(0, 64, 12))
    new = rng.standard_normal((idx.size, 8)).astype(np.float32)
    ring.log_and_apply(0, a.domain("embedding-mirror").get("rows"), idx, new)
    dst = 1 - pool.placement.place("embedding-mirror")
    oracle = {d: _domain_bytes(pool, d)
              for d in ("embedding-mirror", "undo-log")}
    info = pool.migrate_domain("embedding-mirror", dst, compress="zlib")
    assert "embedding-mirror" in info["moved"]
    assert pool.sweep_stale_domains() == []     # the flip GC'd the source
    for dom, regions in oracle.items():
        assert _domain_bytes(pool, dom) == regions
    assert all(s.device.tracker.events["persist"] > 0 for s in pool.shards)
    pool.close()


# ---------------------------------------------------------------------------
# arming drills: the undo ring's gc and grow
# ---------------------------------------------------------------------------


def _dram_checked():
    return make_pool("dram", capacity=1 << 20, check=True)


def _ring_and_mirror(dev, d, rng, max_logs=2):
    """An undo ring and a (1024, d) mirror of random rows on ``dev``. The
    port's ring logs only through the fused ``log_and_apply``: an entry
    holds the mirror's rows at ``idx`` from before the apply."""
    a = PoolAllocator(dev)
    mirror = a.domain("embedding-mirror").alloc("rows", shape=(1024, d),
                                                dtype="float32")
    mirror.write_array(rng.standard_normal((1024, d)).astype(np.float32))
    mirror.persist(point="mirror-load")
    return a, UndoRing(a, max_logs=max_logs, compress="none"), mirror


def _log(ring, mirror, step, idx, rng):
    """Logs and applies random rows at ``idx``; returns the logged rows."""
    old = np.array(mirror.view_array()[idx])
    ring.log_and_apply(step, mirror, idx, rng.standard_normal(
        old.shape).astype(np.float32))
    return old


def test_undo_gc_point_fires():
    dev = _dram_checked()
    rng = np.random.default_rng(3)
    _, ring, mirror = _ring_and_mirror(dev, 8, rng)
    faults = FaultSchedule.drop_at("undo-gc")
    dev.faults = faults
    for step in range(5):
        _log(ring, mirror, step, np.arange(4, dtype=np.int64) + step, rng)
    ring.gc(3)
    assert faults.counts.get("undo-gc", 0) >= 1
    assert set(ring.committed_steps()) == {3, 4}


def test_undo_grow_scrub_point_fires():
    """A grow crashed right after the new generation's alloc published; the
    re-attached writer's next grow scrubs the half-built generation."""
    dev = _dram_checked()
    rng = np.random.default_rng(5)
    a, ring, mirror = _ring_and_mirror(dev, 32, rng)
    small_idx = np.arange(2, dtype=np.int64)
    small = _log(ring, mirror, 0, small_idx, rng)
    dev.faults = FaultSchedule.crash_at("undo-grow-alloc")
    big_idx = np.arange(100, 164, dtype=np.int64)
    with pytest.raises(InjectedCrash):
        _log(ring, mirror, 1, big_idx, rng)
    scrub = FaultSchedule.drop_at("undo-grow-scrub", occurrence=10 ** 9)
    dev.faults = scrub
    ring2 = UndoRing(PoolAllocator(dev), max_logs=2, compress="none")
    big = _log(ring2, mirror, 1, big_idx, rng)  # reuses and scrubs ring1
    assert scrub.counts.get("undo-grow-scrub", 0) >= 1
    got_idx, got_rows, _ = ring2.read(0)        # carried over intact
    np.testing.assert_array_equal(got_idx, small_idx)
    np.testing.assert_array_equal(got_rows, small)
    g1_idx, g1_rows, _ = ring2.read(1)
    np.testing.assert_array_equal(g1_idx, big_idx)
    np.testing.assert_array_equal(g1_rows, big)


@pytest.mark.parametrize("point,kind,phase,stranded", [
    # carry done, flip not durable: ring1 stays in the directory until the
    # next grow reuses and scrubs it
    ("undo-meta", "crash", "before", True),
    ("undo-meta", "crash", "after", False),     # flip durable
    ("undo-grow-free", "crash", "before", False),   # old generation kept
    ("undo-grow-free", "torn", "before", False),    # its free torn
])
def test_crash_mid_grow_keeps_every_committed_entry(point, kind, phase,
                                                    stranded):
    """A power loss at the grow's meta flip or its free of the old
    generation, under the checker: the reopened ring keeps every committed
    entry, and its open-time sweep leaves one older generation at most."""
    dev = _dram_checked()
    rng = np.random.default_rng(9)
    _, ring, mirror = _ring_and_mirror(dev, 8, rng, max_logs=3)
    rows = {s: _log(ring, mirror, s, np.arange(4) + s, rng) for s in range(2)}
    dev.faults = FaultSchedule(events=(FaultEvent(kind, point, 1, phase),))
    with pytest.raises(InjectedCrash):          # outgrows its slot: grow
        _log(ring, mirror, 2, np.arange(512), rng)
    dev.faults = None
    dev.crash()
    a2 = PoolAllocator(dev)
    ring2 = UndoRing(a2, max_logs=3, compress="none")
    assert ring2.committed_steps() == [0, 1]
    for s in range(2):
        idx, got, _ = ring2.read(s)
        np.testing.assert_array_equal(idx, np.arange(4) + s)
        np.testing.assert_array_equal(got, rows[s])
    want = ["meta", "ring0", "ring1"] if stranded else ["meta", "ring1"]
    assert sorted(a2.domain("undo-log").regions()) == want
    assert ring2.gen == (0 if stranded else 1)


# ---------------------------------------------------------------------------
# arming drills: the manager's manifest points and the recovery rollback
# ---------------------------------------------------------------------------


def _smoke_setup(tmp, dense_interval=1):
    cc = CheckpointConfig(directory=tmp, dense_interval=dense_interval,
                          pool_backend="pmem", pool_compress="zlib")
    cfg = get_arch("tinyllama-1.1b", smoke=True).model
    tc = TrainConfig(embed_learning_rate=0.05, checkpoint=cc)
    return cfg, tc, cc, make_batches(cfg, 4, 16, seed=3, device="cpu")


def test_manager_manifest_points_fire(tmp_path):
    """Silent drops at the manifest barriers and the apply/manifest window:
    all three fire in a short run (counted by one schedule armed at all
    three), and training completes."""
    cfg, tc, cc, data = _smoke_setup(str(tmp_path / "ck"))
    faults = FaultSchedule(events=tuple(
        FaultEvent("drop", point, 10 ** 9)
        for point in ("manifest-init", "manifest-dense",
                      "tier_e.between-apply-and-manifest")))
    st0 = train_loop.init_state(cfg, tc, "cpu")
    mgr = CheckpointManager(cfg, cc, embed_init=st0["embed"], faults=faults)
    train_loop.train(cfg, tc, data, 3, relaxed=True, state=st0,
                     ckpt_manager=mgr, device="cpu")
    mgr.flush()
    for point in ("manifest-init", "manifest-dense",
                  "tier_e.between-apply-and-manifest"):
        assert faults.counts.get(point, 0) >= 1, point
    mgr.pool.close()


def test_rollback_point_fires_on_recovery(tmp_path):
    """A crash between the mirror apply and the manifest advance: recovery
    finds a committed entry newer than the manifest and rolls it back
    through the named ``rollback`` barrier, under the checker."""
    tmp = str(tmp_path / "ck")
    cfg, tc, cc, data = _smoke_setup(tmp, dense_interval=0)
    faults = FaultSchedule.crash_at("tier_e.between-apply-and-manifest",
                                    occurrence=4)
    st0 = train_loop.init_state(cfg, tc, "cpu")
    mgr = CheckpointManager(cfg, cc, embed_init=st0["embed"], faults=faults)
    with pytest.raises(InjectedCrash):
        train_loop.train(cfg, tc, data, 6, relaxed=True, state=st0,
                         ckpt_manager=mgr, device="cpu")
    mgr.pool.close()
    dev = CheckedPool(PmemPool.open(os.path.join(tmp, "pool.img")))
    sched = FaultSchedule.drop_at("rollback", occurrence=10 ** 9)
    dev.faults = sched                          # an occurrence counter
    rec = recovery.recover(tmp, pool=dev)
    assert rec.rolled_back and rec.mirror_step == 2
    assert sched.counts.get("rollback", 0) >= 1
    dev.close()
