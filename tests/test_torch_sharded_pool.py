"""The port's sharded pool (``repro_torch.pool.sharded``), placement and
read replica against the JAX package's, on the CPU.

Placement: the port's ``PlacementMap`` gives the JAX package's assignment
for a spread of domain names, shard counts, pins and epochs, and the two
read each other's JSON. The cases of ``tests/test_sharded_pool.py`` and
``tests/test_placement.py`` run on the port's trainer and the port's
memory nodes (in-process ``PoolServer``s on unix sockets; pmem where a node
restarts over its image, dram elsewhere): routing and tenancy per shard,
the fused append's link bytes, the migration crash windows, the
crash/partition matrix and the permanent-node-loss matrix, each recovery
bitwise against a clean replay. Then the packages are held against each
other: the port's trainer over the JAX package's nodes, a POOL.json and
nodes written by either package recovered by the other, and a region above
the split size replicated, promoted and migrated bitwise through either
package's node (the JAX package's one-frame copy refused there). Last, the
serving tier's replica failover. Every node is shut down in a ``finally``.
"""
import dataclasses
import json
import os
import zlib

import jax
import numpy as np
import pytest
import torch

import repro.pool as R
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import CheckpointConfig as JaxCheckpointConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.checkpoint import recovery as jrecovery
from repro.core.checkpoint.manager import CheckpointManager as JaxManager
from repro.data.synthetic import make_batches as jax_make_batches
from repro.pool import protocol as rproto
from repro.pool import sharded as rsharded
from repro.training import train_loop as jtl
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.core.checkpoint.undo_log import UndoRing
from repro_torch.data.synthetic import make_batches
from repro_torch.pool import (DramPool, FaultSchedule, InjectedCrash, NmpQueue,
                              PlacementMap, PmemPool, PoolAllocator,
                              PoolConnectionError, PoolError, PoolServer,
                              ShardedPool, TenantIsolationError,
                              replica_domain)
from repro_torch.pool import protocol
from repro_torch.pool.sharded import (MIGRATE_WINDOWS, SHARD_SPAN,
                                      region_pieces)
from repro_torch.serve import EmbeddingServeTier, ReplicaReader
from repro_torch.training import train_loop

COMPRESS = "zlib"
STEPS = 6
SCENARIOS = ("kill-shard", "torn-shard", "partition", "all-restart")
MANAGER_DOMAINS = ("embedding-mirror", "undo-log", "manifest", "dense")
ARCH = "tinyllama-1.1b"
RESUME_TOL = dict(rtol=1e-5, atol=1e-6)    # tests/test_sharded_pool.py's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized steps gain nothing from intra-op threads, and the nodes'
    threads and the other test workers compete for the cores: one thread
    halves this module's CPU time. The previous count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shard_index(off: int) -> int:
    return int(off) // SHARD_SPAN


def _occ(scenario: str, nshards: int) -> int:
    """The drill's step, as tests/test_sharded_pool.py draws it."""
    return zlib.crc32(f"{scenario}:{nshards}".encode()) % 3 + 2


def _start_servers(tmp_path, n, backend="pmem", tag="", pkg=None):
    """n in-process memory nodes (the port's, or ``pkg``'s) on unix
    sockets; pmem nodes on ``node<tag><i>.img``."""
    Server, Dram, Pmem = (PoolServer, DramPool, PmemPool) if pkg is None \
        else (pkg.PoolServer, pkg.DramPool, pkg.PmemPool)
    servers = []
    for i in range(n):
        dev = Pmem(str(tmp_path / f"node{tag}{i}.img"), 1 << 21) \
            if backend == "pmem" else Dram(1 << 21)
        servers.append(Server(dev, f"unix:{tmp_path}/n{tag}{i}.sock").start())
    return servers


def _shutdown(servers):
    for s in servers:
        s.shutdown(close_device=True)


# -- placement: the same assignment as the JAX package's ---------------------------

DOMAINS = MANAGER_DOMAINS + ("embedding-ops", "scratch", "ballast", "dense@w1",
                             "manifest@w1", "manifest@w2", "x" * 40, "t/1",
                             "embedding-mirror@replica", "undo-log@replica")


@pytest.mark.parametrize("nshards", [1, 2, 3, 5])
def test_placement_equals_the_references(nshards):
    """For each shard count: the hashed assignment of a spread of domain
    names, then with pins, then after two epochs of moves, equals the JAX
    package's; each package reads the other's JSON to the same map (torn
    tail record included), and the groups and the CLI parse agree."""
    shards = tuple(f"unix:/n{i}.sock" for i in range(nshards))
    pin = {"manifest": nshards - 1, "dense": 0}
    plain = [PlacementMap(shards=shards), R.PlacementMap(shards=shards)]
    pinned = [PlacementMap(shards=shards, pin=pin),
              R.PlacementMap(shards=shards, pin=pin)]
    for a, b in (plain, pinned):
        assert [a.place(d) for d in DOMAINS] == [b.place(d) for d in DOMAINS]
        assert [a.group(d) for d in DOMAINS] == [b.group(d) for d in DOMAINS]
    home = pinned[0].place("embedding-mirror")
    moves = [{"embedding-mirror": (home + 1) % nshards,
              "undo-log": (home + 1) % nshards},
             {"scratch": (home + 2) % nshards}]
    port, ref = pinned
    for k, mv in enumerate(moves):
        port = port.with_epoch(mv, reason=f"mv{k}")
        ref = ref.with_epoch(mv, reason=f"mv{k}")
    assert port.to_json() == ref.to_json()
    assert [port.place(d) for d in DOMAINS] == [ref.place(d) for d in DOMAINS]
    assert PlacementMap.from_json(ref.to_json()) == port
    assert R.PlacementMap.from_json(port.to_json()) == ref
    torn = port.to_json()
    torn["epochs"][-1]["crc"] ^= 1
    assert PlacementMap.from_json(torn).epoch \
        == R.PlacementMap.from_json(torn).epoch == 1
    spec = ",".join(shards), f"manifest={nshards - 1},dense=0"
    assert PlacementMap.parse(*spec).to_json() == R.PlacementMap.parse(*spec).to_json()


def test_placement_contract():
    """tests/test_sharded_pool.py's and tests/test_placement.py's
    PlacementMap cases on the port: pure and stable, undo-log with its
    mirror, pins over the hash, epochs newest first, the group, and a torn
    or out-of-order record falling back to the epochs before it."""
    t = PlacementMap(shards=("tcp:a:1", "tcp:b:1", "tcp:c:1"))
    for dom in MANAGER_DOMAINS:
        assert t.place(dom) == PlacementMap(shards=t.shards).place(dom)
    assert t.place("undo-log") == t.place("embedding-mirror")
    assert PlacementMap(shards=("a", "b"), pin={"manifest": 1}).place("manifest") == 1
    with pytest.raises(PoolError):
        PlacementMap(shards=("a",), pin={"manifest": 5}).place("manifest")
    assert t.group("embedding-mirror") == ["embedding-mirror", "undo-log"]
    home = t.place("embedding-mirror")
    split = t.with_pin("undo-log", (home + 1) % 3)
    assert split.group("embedding-mirror") == ["embedding-mirror"]
    pm2 = t.with_epoch({"embedding-mirror": (home + 1) % 3,
                        "undo-log": (home + 1) % 3}) \
        .with_epoch({"embedding-mirror": (home + 2) % 3,
                     "undo-log": (home + 2) % 3})
    assert pm2.place("undo-log") == pm2.place("embedding-mirror") == (home + 2) % 3
    assert pm2.place("manifest") == t.place("manifest")
    obj = pm2.to_json()
    obj["epochs"] = [obj["epochs"][1]]          # epoch 2 without epoch 1
    assert PlacementMap.from_json(obj).place("embedding-mirror") == home
    # only an explicit pin separates the fused op's two regions
    dev = ShardedPool([DramPool(1 << 16), DramPool(1 << 16)],
                      pin={"undo-log": 0, "embedding-mirror": 1})
    assert dev.topology.place("undo-log") != dev.topology.place("embedding-mirror")


# -- routing, tenancy and metrics over the port's nodes ----------------------------

def test_cross_shard_fallback_append_is_correct(rng):
    """An explicit pin separating mirror and log degrades the fused append
    to the host-driven path: the same commit protocol and recovery."""
    dev = ShardedPool([DramPool(1 << 18), DramPool(1 << 18)],
                      pin={"undo-log": 0, "embedding-mirror": 1})
    a = PoolAllocator(dev)
    tab = rng.standard_normal((64, 8)).astype(np.float32)
    mirror = a.domain("embedding-mirror").alloc("rows", shape=tab.shape,
                                                dtype="float32")
    mirror.write_array(tab)
    mirror.persist(point="load")
    ring = UndoRing(a, max_logs=4, compress=COMPRESS)
    assert shard_index(ring.meta.region.off) != shard_index(mirror.off)
    idx = np.unique(rng.integers(0, 64, 16))
    new = rng.standard_normal((idx.size, 8)).astype(np.float32)
    ring.log_and_apply(0, mirror, idx, new)
    got_idx, got_rows, _ = ring.read(0)
    np.testing.assert_array_equal(got_idx, idx)
    np.testing.assert_array_equal(got_rows, tab[idx])
    dev.crash()
    np.testing.assert_array_equal(mirror.read_array()[idx], new)


def test_tenancy_metrics_and_reconnect_per_shard(tmp_path, rng):
    """On two port nodes: isolation holds on whichever node a tenant's
    bytes live; the merged metrics sum the shards and stay attributed per
    tenant; a node that restarts over its image is dialed again in place
    and serves the same bytes at the same offsets."""
    servers = _start_servers(tmp_path, 2)
    try:
        addrs = [s.addr for s in servers]
        pool_a = ShardedPool(addrs, tenant="a", pin={"d0": 0, "d1": 1})
        idle = ShardedPool(addrs, tenant="idle")
        regions = {}
        for dom in ("d0", "d1"):
            r = PoolAllocator(pool_a).domain(dom).alloc("x", shape=(64,),
                                                        dtype="float32")
            r.write_array(rng.standard_normal(64).astype(np.float32))
            r.persist(point="p")
            regions[dom] = r
        assert [shard_index(regions[d].off) for d in ("d0", "d1")] == [0, 1]
        eve = ShardedPool(addrs, tenant="eve", pin={"d0": 0, "d1": 1})
        for r in regions.values():
            with pytest.raises(TenantIsolationError):
                eve.read(r.off, r.nbytes)
            with pytest.raises(TenantIsolationError):
                NmpQueue(eve).gather(r, np.array([0]))
        per_shard = pool_a.shard_metrics()
        assert all(s["media_bytes"] > 0 for s in per_shard)
        assert pool_a.metrics.media_bytes() == sum(s["media_bytes"]
                                                   for s in per_shard)
        assert idle.metrics.media_bytes() == 0
        want = regions["d0"].read_array()
        servers[0].shutdown(close_device=True)
        with pytest.raises(PoolError):
            pool_a.read(regions["d0"].off, regions["d0"].nbytes)
        assert pool_a.shard_metrics()[0]["unreachable"]
        servers[0] = PoolServer(PmemPool.open(str(tmp_path / "node0.img")),
                                addrs[0]).start()
        pool_a.reconnect_shard(0)
        np.testing.assert_array_equal(regions["d0"].read_array(), want)
        for p in (pool_a, idle, eve):
            p.close()
    finally:
        _shutdown(servers)


def _port_run(cc, steps, state=None, start=0, mgr=None):
    cfg = get_arch(ARCH, smoke=True).model
    tc = TrainConfig(embed_learning_rate=0.05, checkpoint=cc)
    data = make_batches(cfg, 4, 16, seed=3, device="cpu")
    if state is None:
        state = train_loop.init_state(cfg, tc, "cpu")
    if mgr is None:
        mgr = CheckpointManager(cfg, cc, embed_init=state["embed"])
    state, losses = train_loop.train(cfg, tc, data, steps, relaxed=True,
                                     state=state, start_step=start,
                                     ckpt_manager=mgr, device="cpu")
    return mgr, state, losses


def test_manager_spreads_domains_and_keeps_the_link_bound(tmp_path, rng):
    """The manager places its domains per the placement (manifest and
    dense pinned off the mirror's node) and a recovery from POOL.json finds
    every region at the offset it was first given; after a live migration
    of the mirror group, the fused append's link bytes per step stay within
    idx + new rows + 4 KB on the new node."""
    servers = _start_servers(tmp_path, 2, backend="dram")
    try:
        addrs = [s.addr for s in servers]
        hot = PlacementMap(shards=tuple(addrs)).place("embedding-mirror")
        cc = CheckpointConfig(
            directory=str(tmp_path / "ck"), dense_interval=1,
            pool_backend="sharded", pool_shards=",".join(addrs),
            pool_placement=f"manifest={1 - hot},dense={1 - hot}",
            pool_compress=COMPRESS)
        mgr, _, _ = _port_run(cc, 3)
        mgr.flush()
        assert shard_index(mgr.mirror_region.off) == hot
        assert shard_index(mgr.manifest.region.off) == 1 - hot
        placed = {(dom, n): r.off for dom in MANAGER_DOMAINS
                  for n, r in PoolAllocator(mgr.pool).domain(dom).regions().items()}
        mgr.pool.close()
        rec = recovery.recover(cc.directory)
        assert rec.mirror_step == 2
        assert {(dom, n): r.off for dom in MANAGER_DOMAINS
                for n, r in PoolAllocator(rec.pool).domain(dom).regions().items()} \
            == placed
        mgr = CheckpointManager(get_arch(ARCH, smoke=True).model,
                                dataclasses.replace(cc, dense_interval=0),
                                pool=rec.pool)
        table = torch.from_numpy(np.array(rec.embed_rows).reshape(rec.table_shape))
        mgr.init_mirror({"table": table}, step=rec.mirror_step)
        info = mgr.pool.migrate_domain("embedding-mirror", 1 - hot,
                                       compress=COMPRESS)
        assert set(info["moved"]) == {"embedding-mirror", "undo-log"}
        mgr.rebind_domains(info["moved"])
        assert shard_index(mgr.mirror_region.off) == 1 - hot
        d, nrows = mgr.mirror_region.shape[-1], mgr.mirror_region.shape[0]
        idx = np.unique(rng.integers(0, nrows, 32)).astype(np.int64)
        new = rng.standard_normal((idx.size, d)).astype(np.float32)
        mgr._do_tier_e(3, idx, new)
        mgr.pool.reset_metrics()
        for step in (4, 5, 6):
            mgr._do_tier_e(step, idx, new)
        m = mgr.pool.metrics
        assert m.link_bytes() <= 3 * (idx.nbytes + new.nbytes + 4096)
        assert m.media_bytes("undo_snapshot") == 3 * idx.size * d * 4
        mgr.pool.close()
    finally:
        _shutdown(servers)


def _domain_bytes(pool, domain):
    return {name: bytes(pool.read(r.off, r.nbytes, tag="oracle"))
            for name, r in PoolAllocator(pool).domain(domain).regions().items()}


@pytest.mark.parametrize("window", MIGRATE_WINDOWS)
def test_migration_crash_window_matrix(tmp_path, rng, window):
    """tests/test_placement.py's matrix on two port nodes: a crash at each
    named migration window recovers bitwise, the domain group wholly on the
    pre-flip source or the post-flip destination, the stranded copy swept
    (and a second sweep frees nothing)."""
    paths = [str(tmp_path / f"m{i}.img") for i in range(2)]
    servers = [PoolServer(PmemPool(p, 1 << 20), f"unix:{tmp_path}/m{i}.sock")
               .start() for i, p in enumerate(paths)]
    sink_file = str(tmp_path / "placement.json")

    def sink(pm):
        with open(sink_file + ".tmp", "w") as f:
            json.dump(pm.to_json(), f)
        os.replace(sink_file + ".tmp", sink_file)
    try:
        pool = ShardedPool([s.addr for s in servers])
        pool.epoch_sink = sink
        sink(pool.placement)
        a = PoolAllocator(pool)
        tab = rng.standard_normal((96, 8)).astype(np.float32)
        mirror = a.domain("embedding-mirror").alloc("rows", shape=tab.shape,
                                                    dtype="float32")
        mirror.write_array(tab)
        mirror.persist(point="mirror-load")
        ring = UndoRing(a, max_logs=4, compress=COMPRESS)
        idx = np.unique(rng.integers(0, 96, 20))
        ring.log_and_apply(0, mirror, idx,
                           rng.standard_normal((idx.size, 8)).astype(np.float32))
        src = pool.placement.place("embedding-mirror")
        oracle = {d: _domain_bytes(pool, d)
                  for d in ("embedding-mirror", "undo-log")}
        pool.faults = FaultSchedule.crash_at(
            window, occurrence=2 if window == "migrate.mid-copy" else 1)
        with pytest.raises(InjectedCrash):
            pool.migrate_domain("embedding-mirror", 1 - src, compress=COMPRESS)
        pool.close()
        for i, s in enumerate(servers):
            s.shutdown(close_device=True)
            servers[i] = PoolServer(PmemPool.open(paths[i]), s.addr).start()
        pool2 = ShardedPool([s.addr for s in servers],
                            placement=PlacementMap.from_json(
                                json.load(open(sink_file))))
        swept = pool2.sweep_stale_domains()
        flipped = window == "migrate.post-flip-pre-gc"
        owner, stale = (1 - src, src) if flipped else (src, 1 - src)
        assert pool2.placement.place("undo-log") \
            == pool2.placement.place("embedding-mirror") == owner
        if window != "migrate.pre-copy":
            assert any(s == stale for _, s in swept), swept
        assert "embedding-mirror" not in pool2.shard_domains(stale)
        assert pool2.sweep_stale_domains() == []
        for dom, regions in oracle.items():
            assert _domain_bytes(pool2, dom) == regions, dom
        got_idx, got_rows, _ = UndoRing(PoolAllocator(pool2), 4).read(0)
        np.testing.assert_array_equal(got_idx, idx)
        np.testing.assert_array_equal(got_rows, tab[idx])
        pool2.close()
    finally:
        _shutdown(servers)


# -- the crash/partition matrix and the permanent-node-loss matrix -----------------

@pytest.fixture(scope="module")
def ref_ctx(tmp_path_factory):
    """One clean run on a dram pool: each step's mirror (the bitwise
    oracle) and the uninterrupted losses."""
    root = str(tmp_path_factory.mktemp("sharded_ref"))
    cc = CheckpointConfig(directory=root, dense_interval=1, pool_backend="dram",
                          pool_compress=COMPRESS)
    cfg = get_arch(ARCH, smoke=True).model
    tc = TrainConfig(embed_learning_rate=0.05, checkpoint=cc)
    data = make_batches(cfg, 4, 16, seed=3, device="cpu")
    _, full_losses = train_loop.train(cfg, tc, data, STEPS + 3, relaxed=True,
                                      device="cpu")
    state = train_loop.init_state(cfg, tc, "cpu")
    mgr = CheckpointManager(cfg, cc, embed_init=state["embed"])
    mirrors = {}
    for n in range(STEPS):
        state, _ = train_loop.train(cfg, tc, data, 1, relaxed=True, state=state,
                                    start_step=n, ckpt_manager=mgr, device="cpu")
        mirrors[n] = np.array(mgr.mirror_rows)
    mgr.close()
    return mirrors, np.asarray(full_losses)


def _recover_and_resume(ref_ctx, root, **cc_kw):
    mirrors, full_losses = ref_ctx
    rec = recovery.recover(root)
    assert rec.mirror_step >= 0
    np.testing.assert_array_equal(rec.embed_rows, mirrors[rec.mirror_step])
    cfg = get_arch(ARCH, smoke=True).model
    cc = CheckpointConfig(directory=root, dense_interval=1,
                          pool_backend="sharded", pool_compress=COMPRESS, **cc_kw)
    tc = TrainConfig(embed_learning_rate=0.05, checkpoint=cc)
    state, resume = recovery.resume_train_state(
        rec, train_loop.init_state(cfg, tc, "cpu"))
    mgr = CheckpointManager(cfg, cc, pool=rec.pool)
    mgr.init_mirror(state["embed"], step=rec.mirror_step)
    _, tail = train_loop.train(cfg, tc, make_batches(cfg, 4, 16, seed=3,
                                                     device="cpu"),
                               3, relaxed=True, state=state, start_step=resume,
                               ckpt_manager=mgr, device="cpu")
    mgr.flush()
    if rec.gap == 0:
        np.testing.assert_allclose(tail, full_losses[resume:resume + 3],
                                   **RESUME_TOL)
    else:
        assert np.isfinite(tail).all()
    return rec, mgr


@pytest.mark.parametrize("nshards", [2, 3])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sharded_fault_matrix(tmp_path, ref_ctx, scenario, nshards):
    """tests/test_sharded_pool.py's matrix on the port's nodes: one node
    killed mid-step (restarted over its image), a torn write on one node,
    a partition during the fused append, and every node restarting; the
    surviving nodes' counters untouched, recovery bitwise."""
    # a node restarts over its image only when killed or restarted
    restarts = scenario in ("kill-shard", "all-restart")
    servers = _start_servers(tmp_path, nshards,
                             backend="pmem" if restarts else "dram")
    addrs = [s.addr for s in servers]
    root = str(tmp_path / "ck")
    cc = CheckpointConfig(directory=root, dense_interval=1,
                          pool_backend="sharded", pool_shards=",".join(addrs),
                          pool_compress=COMPRESS)
    hot = PlacementMap(shards=tuple(addrs)).place("embedding-mirror")
    upto = _occ(scenario, nshards)
    survivors = [i for i in range(nshards) if i != hot]
    try:
        if scenario == "all-restart":
            mgr, _, _ = _port_run(cc, STEPS)
            mgr.flush()
            mgr.pool.close()
            for i, s in enumerate(servers):
                s.shutdown(close_device=True)
                servers[i] = PoolServer(
                    PmemPool.open(str(tmp_path / f"node{i}.img")),
                    addrs[i]).start()
            rec, mgr2 = _recover_and_resume(ref_ctx, root)
            assert rec.mirror_step == STEPS - 1
            mgr2.pool.close()
            return
        mgr, state, _ = _port_run(cc, upto)
        mgr.flush()
        pre = {i: mgr.pool.shard_metrics()[i] for i in survivors}
        if scenario == "kill-shard":
            servers[hot].shutdown(close_device=True)
        elif scenario == "torn-shard":
            mgr.pool.set_shard_faults(
                hot, FaultSchedule.torn_at("mirror-apply", occurrence=1))
        else:
            mgr.pool.shards[hot].device._sock.close()
        with pytest.raises((RuntimeError, InjectedCrash, PoolError)):
            _port_run(cc, STEPS - upto, state=state, start=upto, mgr=mgr)
            mgr.flush()
        if scenario == "torn-shard":
            mgr.pool.crash_shard(hot)
        for i in survivors:
            snap = mgr.pool.shard_metrics()[i]
            assert snap["torn_writes"] == 0 and snap["crashes"] == 0
            assert snap["media_bytes"] >= pre[i]["media_bytes"]
        mgr.pool.close()
        if scenario == "kill-shard":
            servers[hot] = PoolServer(
                PmemPool.open(str(tmp_path / f"node{hot}.img")),
                addrs[hot]).start()
        rec, mgr2 = _recover_and_resume(ref_ctx, root)
        if scenario == "torn-shard":
            assert rec.rolled_back
        assert rec.mirror_step >= upto - 1
        mgr2.pool.close()
    finally:
        _shutdown(servers)


def test_replica_refresh_used_bytes_flat(rng):
    """Ten refreshes of one domain leave the replica shard's used bytes
    flat, and a region the source retired is freed on the next refresh."""
    dev = ShardedPool([DramPool(1 << 20), DramPool(1 << 20)],
                      pin={"embedding-mirror": 0})
    dom = PoolAllocator(dev).domain("embedding-mirror")
    r = dom.alloc("rows", shape=(64, 8), dtype="float32")
    r.write_array(rng.standard_normal((64, 8)).astype(np.float32))
    r.persist(point="mirror-load")
    dev.replicate_domain("embedding-mirror", 1, watermark=0)
    flat = dev.shard_metrics()[1]["used_bytes"]
    for k in range(1, 11):
        dev.replicate_domain("embedding-mirror", 1, watermark=k)
        assert dev.shard_metrics()[1]["used_bytes"] == flat
    dom.free_region("rows")
    r2 = dom.alloc("rows2", shape=(96, 8), dtype="float32")
    r2.write_array(np.zeros((96, 8), np.float32))
    r2.persist(point="mirror-load")
    dev.replicate_domain("embedding-mirror", 1, watermark=11)
    rep = PoolAllocator(dev).domain(replica_domain("embedding-mirror"))
    assert set(rep.regions()) == {"rows2", "watermark"}
    dev.close()


# each cell loses one role: the mirror + undo ring, the manifest's primary,
# or the replica destination (also witness 1); dense rides a survivor
LOSS_CELLS = {"mirror": (0, "embedding-mirror=0,manifest=1,dense=1"),
              "manifest": (1, "embedding-mirror=0,manifest=1,dense=0"),
              "replica": (2, "embedding-mirror=0,manifest=1,dense=1")}


@pytest.mark.parametrize("when", ["mid-step", "after-crash"])
@pytest.mark.parametrize("lost", sorted(LOSS_CELLS))
def test_permanent_node_loss_matrix(tmp_path, ref_ctx, lost, when):
    """tests/test_sharded_pool.py's matrix on three port nodes: a node is
    killed and its image deleted. The replica destination's loss degrades
    (counted) and training goes on; the mirror node's loss promotes the
    commit-coupled replica in ONE epoch and recovers bitwise at the
    replication watermark; the manifest primary's loss leaves the 2-of-3
    witnesses electing. Reads routed at the dead node raise typed errors."""
    mirrors, _ = ref_ctx
    dead, pins = LOSS_CELLS[lost]
    servers = _start_servers(tmp_path, 3, tag=f"{lost[:3]}{when[:3]}")
    addrs = [s.addr for s in servers]
    root = str(tmp_path / "ck")
    cc = CheckpointConfig(
        directory=root, dense_interval=1, pool_backend="sharded",
        pool_shards=",".join(addrs), pool_placement=pins,
        pool_compress=COMPRESS, pool_replica=2, pool_replica_every=2,
        pool_ckpt_replica=2, pool_manifest_quorum=True)
    upto = 4
    try:
        mgr, state, _ = _port_run(cc, upto)
        mgr.flush()
        assert mgr.stats["ship_steps"] == upto
        assert mgr.stats["ship_full_refreshes"] >= 1
        assert mgr.stats["replica_refresh_failures"] == 0
        servers[dead].shutdown(close_device=True)
        os.unlink(str(tmp_path / f"node{lost[:3]}{when[:3]}{dead}.img"))
        if lost == "replica":
            _port_run(cc, STEPS - upto, state=state, start=upto, mgr=mgr)
            mgr.flush()
            assert mgr.stats["replica_refresh_failures"] >= 1
            assert mgr.stats["manifest_witness_failures"] >= 1
            np.testing.assert_array_equal(np.array(mgr.mirror_rows),
                                          mirrors[STEPS - 1])
            mgr.pool.close()
            if when == "after-crash":
                rec, mgr2 = _recover_and_resume(ref_ctx, root)
                assert rec.mirror_step == STEPS - 1
                mgr2.pool.close()
            return
        if when == "after-crash":
            with pytest.raises((RuntimeError, InjectedCrash, PoolError)):
                _port_run(cc, STEPS - upto, state=state, start=upto, mgr=mgr)
                mgr.flush()
        mgr.pool.close()
        pool = recovery.open_pool(root)
        assert pool.dead_shards() == [dead]
        epoch0 = pool.placement.epoch
        pool.epoch_sink = lambda pm: recovery.record_placement(root, pool)
        if lost == "mirror":
            info = pool.promote_replica("embedding-mirror", compress=COMPRESS)
            assert set(info["promoted"]) == {"embedding-mirror", "undo-log"}
        else:
            info = pool.promote_replica("manifest", compress=COMPRESS,
                                        from_domain="manifest@w1")
            assert info["promoted"] == ("manifest",)
        assert info["epoch"] == epoch0 + 1
        assert all(d == 2 for d in info["dst"].values())
        with pytest.raises(PoolConnectionError):
            pool.read(dead * SHARD_SPAN, 8)
        pool.close()
        rec, mgr2 = _recover_and_resume(ref_ctx, root)
        if lost == "mirror":
            assert rec.mirror_step == 2 and rec.rolled_back
        else:
            assert rec.mirror_step == upto - 1
        mgr2.pool.close()
    finally:
        _shutdown(servers)


# -- the two packages against each other -------------------------------------------

def _jax_sharded_run(root, addrs, steps):
    jcfg = jax_get_arch(ARCH, smoke=True).model
    cc = JaxCheckpointConfig(directory=root, dense_interval=1,
                             pool_backend="sharded", pool_shards=",".join(addrs),
                             pool_placement="manifest=1,dense=1",
                             pool_compress=COMPRESS)
    jtc = JaxTrainConfig(embed_learning_rate=0.05, checkpoint=cc)
    st0 = jtl.make_step_fns(jcfg, jtc)[0](jax.random.PRNGKey(0))
    mgr = JaxManager(jcfg, cc, embed_init=st0["embed"])
    jtl.train(jcfg, jtc, jax_make_batches(jcfg, 4, 16, seed=3), steps,
              relaxed=True, state=st0, ckpt_manager=mgr)
    mgr.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pool_json_and_nodes_recover_in_the_other_package(tmp_path, writer):
    """A checkpoint written by one package's trainer into the OTHER
    package's two memory nodes, its POOL.json naming them: each package's
    recovery reopens the nodes from it and finds the same placement, the
    same mirror, steps and dense tree, bitwise."""
    pkg = None if writer == "jax" else R        # the nodes: the other's
    servers = _start_servers(tmp_path, 2, backend="dram", pkg=pkg)
    try:
        addrs = [s.addr for s in servers]
        root = str(tmp_path / "ck")
        if writer == "jax":
            _jax_sharded_run(root, addrs, 3)
        else:
            cc = CheckpointConfig(directory=root, dense_interval=1,
                                  pool_backend="sharded",
                                  pool_shards=",".join(addrs),
                                  pool_placement="manifest=1,dense=1",
                                  pool_compress=COMPRESS)
            mgr, _, _ = _port_run(cc, 3)
            mgr.close()
        info = json.load(open(os.path.join(root, "POOL.json")))
        assert info["backend"] == "sharded" and info["shards"] == addrs
        assert info["placement"] == {"manifest": 1, "dense": 1}
        prec = recovery.recover(root)
        jrec = jrecovery.recover(root)
        try:
            assert prec.pool.placement.to_json() == jrec.pool.placement.to_json()
            assert (prec.mirror_step, prec.dense_step) \
                == (jrec.mirror_step, jrec.dense_step) == (2, 2)
            np.testing.assert_array_equal(prec.embed_rows, jrec.embed_rows)
            for a, b in zip(jax.tree_util.tree_leaves(prec.dense["dense"]),
                            jax.tree_util.tree_leaves(jrec.dense["dense"]),
                            strict=True):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        finally:
            prec.pool.close()
            jrec.pool.close()
    finally:
        _shutdown(servers)


def test_region_pieces_cover_the_region():
    """Pieces of at most ``chunk_bytes()`` each, contiguous, uint8, over
    exactly the region's bytes; a small region is itself."""
    from repro_torch.pool.allocator import Region
    from repro_torch.pool.remote import chunk_bytes
    step = chunk_bytes()
    r = Region(None, "d", "rows", 4096, 2 * step + 100, "float32",
               ((2 * step + 100) // 4,))
    ps = region_pieces(r)
    assert [p.nbytes for p in ps] == [step, step, 100]
    assert [p.off for p in ps] == [4096, 4096 + step, 4096 + 2 * step]
    assert all(p.dtype == "uint8" and p.shape == (p.nbytes,) for p in ps)
    small = Region(None, "d", "x", 0, 64, "float32", (16,))
    assert region_pieces(small) == [small]


@pytest.mark.parametrize("node", ["port", "jax"])
def test_region_above_the_split_size_copies_bitwise(tmp_path, monkeypatch,
                                                    rng, node):
    """Both packages' frame caps shrunk to 1 MiB, so a 3.2 MiB mirror is
    above the cap and the port's 64 KiB split size: the port's sharded pool
    over two nodes of ``node``'s package replicates it, promotes the
    replica and migrates the mirror group, each copy bitwise the source, in
    pieces of the split size. The JAX package's sharded pool over its own
    nodes cannot: its one-frame export never fits under the cap (the fault
    of the reference the port avoids)."""
    cap = 1 << 20
    monkeypatch.setattr(protocol, "MAX_FRAME", cap)
    monkeypatch.setattr(rproto, "MAX_FRAME", cap)
    servers = _start_servers(tmp_path, 2, backend="dram",
                             pkg=R if node == "jax" else None)
    try:
        addrs = [s.addr for s in servers]
        pool = ShardedPool(addrs, tenant="port", pin={"embedding-mirror": 0})
        tab = rng.standard_normal((3 * cap // 32 + 7, 8)).astype(np.float32)
        r = PoolAllocator(pool).domain("embedding-mirror").alloc(
            "rows", shape=tab.shape, dtype="float32")
        r.write_array(tab)
        r.persist(point="mirror-load")
        assert r.nbytes > cap and len(region_pieces(r)) == -(-r.nbytes // (cap // 16))
        info = pool.replicate_domain("embedding-mirror", 1, compress="none",
                                     watermark=5)
        assert info["raw_bytes"] == r.nbytes
        rep = ReplicaReader(pool)
        assert rep.watermark() == 5
        got = bytes(pool.read(rep.region.off, rep.region.nbytes))
        assert got == tab.tobytes() and shard_index(rep.region.off) == 1
        # promote the replica under the real name on node 1, then migrate
        # the mirror back to node 0: both bitwise
        pool.promote_replica("embedding-mirror", compress="zlib",
                             from_domain=replica_domain("embedding-mirror"))
        m = PoolAllocator(pool).domain("embedding-mirror").get("rows")
        assert shard_index(m.off) == 1
        assert bytes(pool.read(m.off, m.nbytes)) == tab.tobytes()
        pool.migrate_domain("embedding-mirror", 0, compress="zlib")
        m = PoolAllocator(pool).domain("embedding-mirror").get("rows")
        assert shard_index(m.off) == 0
        assert bytes(pool.read(m.off, m.nbytes)) == tab.tobytes()
        pool.close()
        if node == "port":
            return
        # the reference over its own nodes: the region is one frame, which
        # the node cannot send, so the export's request times out (the
        # deadlines scaled down to 1 s, 4 s for the export), or the node
        # drops the connection first
        jpool = rsharded.ShardedPool(addrs, tenant="jax", timeout=1.0,
                                     pin={"embedding-mirror": 0})
        R.PoolAllocator(jpool).domain("embedding-mirror").alloc(
            "rows", shape=tab.shape, dtype="float32")
        with pytest.raises(R.PoolError,
                           match="timed out|too large|closed the connection"):
            jpool.replicate_domain("embedding-mirror", 1, compress="none")
        jpool.close()
    finally:
        _shutdown(servers)


# -- the serving tier's replica failover ------------------------------------------

def test_tier_fails_over_to_the_replica(tmp_path, rng):
    """A tier over a two-node sharded pool: after the mirror's node is shut
    down, reads fail over to the replica (counted), serve the replicated
    rows bitwise within the declared staleness, the coherence poll keeps
    the last watermark, and without a replica the read raises."""
    servers = _start_servers(tmp_path, 2, backend="dram")
    try:
        pool = ShardedPool([s.addr for s in servers],
                           pin={"embedding-mirror": 0})
        tab = rng.standard_normal((256, 8)).astype(np.float32)
        r = PoolAllocator(pool).domain("embedding-mirror").alloc(
            "rows", shape=tab.shape, dtype="float32")
        r.write_array(tab)
        r.persist(point="mirror-load")
        ring = UndoRing(PoolAllocator(pool), max_logs=8)
        tier = EmbeddingServeTier(pool, cache_rows=16, replica=True)
        bare = EmbeddingServeTier(pool, cache_rows=16)
        assert not tier.replica.ready
        ids = np.array([1, 2, 3])
        new = np.full((3, 8), 7.0, np.float32)
        ring.log_and_apply(0, r, ids, new)
        tab[ids] = new
        tier.serve_batch([ids])
        pool.replicate_domain("embedding-mirror", 1, watermark=0)
        assert tier.replica.refresh() and tier.replica.watermark() == 0
        servers[0].shutdown(close_device=True)
        reqs = [np.array([1, 200, 5]), np.array([250, 2])]
        for got, want_ids in zip(tier.serve_batch(reqs), reqs, strict=True):
            assert got.tobytes() == tab[want_ids].tobytes()
        assert tier.failovers >= 1 and tier.stats()["failovers"] >= 1
        assert tier.staleness_bound() == 0
        assert tier.poll_coherence()["watermark"] == 0
        bags = np.array([[1, 2], [5, 200]])
        np.testing.assert_allclose(tier.bag_lookup(bags), tab[bags].sum(1),
                                   rtol=1e-6)
        with pytest.raises(PoolError):
            bare.serve_batch([np.array([9])])
        pool.close()
    finally:
        _shutdown(servers)
