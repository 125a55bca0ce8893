"""The port's pool-backed serving path against the JAX package, on the CPU.

Each test runs the same seeded numpy inputs through ``repro`` and
``repro_torch``: the near-memory lookup ops and ``EmbeddingPoolMirror``
(``pool/nmp.py``), the undo ring's readers, the serving tier
(``serve/{cache,batcher,coherence,frontend}.py``), the ``pool`` strategy of
``core.embedding_ops``, ``pool_serving`` around smoke LM generation, a
smoke DLRM trained into a pmem pool and read back by both packages' tiers,
and the serve CLI. Rows, caches, invalidations and metric counters are
compared bitwise; logits at ``test_torch_lm.py``'s 1e-4.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import embedding_ops as jeo
from repro.core.checkpoint.undo_log import UndoRing as JUndoRing
from repro.core.checkpoint.undo_log import open_ring as jopen_ring
from repro.data.synthetic import LMBatches as JaxLMBatches
from repro.models.registry import get_api as jax_get_api
from repro.pool import DramPool as JDramPool
from repro.pool import EmbeddingPoolMirror as JMirror
from repro.pool import JsonRegion as JJsonRegion
from repro.pool import NmpQueue as JNmpQueue
from repro.pool import PmemPool as JPmemPool
from repro.pool import PoolAllocator as JPoolAllocator
from repro.pool import PoolMetrics as JPoolMetrics
from repro.pool import TenantIsolationError as JTenantIsolationError
from repro.serve import CommitTailer as JCommitTailer
from repro.serve import EmbeddingServeTier as JTier
from repro.serve import HotRowCache as JHotRowCache
from repro.serve import RequestBatcher as JRequestBatcher
from repro.serve import make_commit_hook as jmake_commit_hook
from repro.training.serve_loop import greedy_generate as jax_greedy_generate
from repro.training.serve_loop import make_serve_fns as jax_make_serve_fns
from repro.training.serve_loop import pool_serving as jax_pool_serving
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core import embedding_ops as eo
from repro_torch.core.checkpoint.manager import CheckpointManager, touched_rows
from repro_torch.core.checkpoint.undo_log import UndoRing, open_ring
from repro_torch.data.synthetic import make_batches
from repro_torch.launch.serve import build_tier
from repro_torch.pool import (DramPool, EmbeddingPoolMirror, JsonRegion,
                              NmpQueue, PmemPool, PoolAllocator, PoolError,
                              PoolMetrics, TenantIsolationError)
from repro_torch.serve import (CommitTailer, EmbeddingServeTier, HotRowCache,
                               RequestBatcher, make_commit_hook)
from repro_torch.training import train_loop
from repro_torch.training.serve_loop import (greedy_generate,
                                             make_pool_serve_fns, pool_serving)

BACKENDS = ["dram", "pmem"]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")

# the two packages' pool classes, side by side
PKGS = {
    "jax": types.SimpleNamespace(
        Dram=JDramPool, Pmem=JPmemPool, Alloc=JPoolAllocator, Nmp=JNmpQueue,
        Mirror=JMirror, Metrics=JPoolMetrics, Cache=JHotRowCache,
        Batcher=JRequestBatcher, Tier=JTier, Ring=JUndoRing,
        open_ring=jopen_ring, Tailer=JCommitTailer, hook=jmake_commit_hook,
        Isolation=JTenantIsolationError, Json=JJsonRegion),
    "port": types.SimpleNamespace(
        Dram=DramPool, Pmem=PmemPool, Alloc=PoolAllocator, Nmp=NmpQueue,
        Mirror=EmbeddingPoolMirror, Metrics=PoolMetrics, Cache=HotRowCache,
        Batcher=RequestBatcher, Tier=EmbeddingServeTier, Ring=UndoRing,
        open_ring=open_ring, Tailer=CommitTailer, hook=make_commit_hook,
        Isolation=TenantIsolationError, Json=JsonRegion),
}


def mkpool(p, backend, tmp_path, name, capacity=1 << 18):
    if backend == "dram":
        return p.Dram(capacity)
    return p.Pmem(str(tmp_path / f"{name}.img"), capacity)


def seed_mirror(p, pool, V=64, d=8):
    rows = np.arange(V * d, dtype=np.float32).reshape(V, d)
    reg = p.Alloc(pool).domain("embedding-mirror").alloc(
        "rows", shape=(V, d), dtype="float32")
    reg.write_array(rows)
    reg.persist(point="mirror-load")
    return reg, rows


def counters(m):
    """Every counter the two packages' ``PoolMetrics`` share, exactly."""
    return ({k: vars(s) for k, s in m.media.items()},
            {k: vars(s) for k, s in m.link.items()},
            m.ndp_time_s, m.comp_raw_bytes, m.comp_stored_bytes,
            m.cache_hits, m.cache_misses, m.cache_invalidations,
            m.cache_hit_rate())


def assert_same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def both(fn):
    """fn(package namespace, name) for each package -> {name: result}."""
    return {name: fn(p, name) for name, p in PKGS.items()}


# -- near-memory lookup ops ---------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_nmp_lookup_ops_match_jax(backend, tmp_path, rng):
    """gather, bag_gather (sum, mean, and over stacked (T, R, d) tables
    with per-table offsets, which the port adds from the region's shape
    where the JAX package takes them as ``offsets``), scatter_add with
    repeated ids, undo_snapshot: results and counters bitwise."""
    table = rng.standard_normal((64, 8)).astype(np.float32)
    idx2 = rng.integers(0, 64, (3, 5))
    bags = rng.integers(0, 16, (2, 4, 6))
    off = (np.arange(4)[None, :, None] * 16).astype(bags.dtype)
    dup = np.array([3, 9, 3, 60, 9, 3])
    delta = rng.standard_normal((6, 8)).astype(np.float32)

    def run(p, name):
        pool = mkpool(p, backend, tmp_path, name)
        dom = p.Alloc(pool).domain("d")
        reg = dom.alloc("t", shape=(64, 8), dtype="float32")
        reg.write_array(table)
        stacked = dom.alloc("s", shape=(4, 16, 8), dtype="float32")
        stacked.write_array(table.reshape(4, 16, 8))
        reg.persist(point="p")
        stacked.persist(point="p")
        q = p.Nmp(pool)
        offsets = {"offsets": off} if name == "jax" else {}
        out = [q.gather(reg, idx2), q.bag_gather(stacked, bags, **offsets),
               q.bag_gather(reg, idx2, combine="mean"),
               q.undo_snapshot(reg, dup)]
        q.scatter_add(reg, dup, delta, point="mirror-apply")
        out.append(reg.read_array())
        pool.crash()                      # the apply was persisted
        out.append(reg.read_array())
        return out, counters(pool.metrics)

    got = both(run)
    for a, b in zip(got["port"][0], got["jax"][0], strict=True):
        assert_same_bits(a, b)
    assert got["port"][1] == got["jax"][1]
    out = got["port"][0]
    assert_same_bits(out[0], table[idx2])
    np.testing.assert_allclose(out[1], table[bags + off].sum(-2), rtol=1e-6)
    assert got["port"][1][2] > 0          # the adder array was charged


def test_bag_gather_stacked_ids_must_name_every_table():
    """Over a stacked (T, R, d) region the ids' second-to-last axis is the
    table axis: ids that do not have T tables raise."""
    pool = DramPool(1 << 18)
    reg = PoolAllocator(pool).domain("d").alloc("s", shape=(4, 16, 8),
                                                dtype="float32")
    q = NmpQueue(pool)
    for bad in (np.zeros(6, np.int64), np.zeros((2, 3, 6), np.int64)):
        with pytest.raises(ValueError, match="4 stacked tables"):
            q.bag_gather(reg, bad)
    assert q.bag_gather(reg, np.zeros((4, 6), np.int64)).shape == (4, 8)


@pytest.mark.parametrize("backend", BACKENDS)
def test_embedding_pool_mirror_matches_jax(backend, tmp_path, rng):
    """lookup, the stacked-table bag_lookup, sync_from and apply_grad."""
    tabs = rng.standard_normal((4, 16, 8)).astype(np.float32)
    flat = rng.standard_normal((32, 8)).astype(np.float32)
    ids = rng.integers(0, 16, (3, 4, 5))

    def run(p, name):
        pool = mkpool(p, backend, tmp_path, name, capacity=1 << 20)
        mir = p.Mirror(pool, tabs)
        out = [mir.lookup(np.array([[1, 5], [63, 0]])), mir.bag_lookup(ids)]
        mir.apply_grad(np.array([0, 1, 0]), np.ones((3, 8), np.float32), lr=0.5)
        out.append(mir.region.read_array())
        mir.sync_from(tabs * 2)
        out.append(mir.lookup(np.arange(64)))
        flat_mir = p.Mirror(pool, flat, name="flat")
        out.append(flat_mir.bag_lookup(np.array([[1, 2, 3], [31, 0, 0]])))
        return out, counters(mir.metrics), tuple(mir.shape)

    got = both(run)
    for a, b in zip(got["port"][0], got["jax"][0], strict=True):
        assert_same_bits(a, b)
    assert got["port"][1:] == got["jax"][1:]
    want = tabs.reshape(64, 8)[(ids + np.arange(4)[None, :, None] * 16)].sum(2)
    np.testing.assert_allclose(got["port"][0][1], want, rtol=1e-6)


# -- the undo ring's readers --------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_undo_ring_readers_match_jax(backend, tmp_path, rng):
    """read_many and committed_after over the same commits (a ring grow
    among them), and a readonly ring: it reads, and refuses to write."""
    new = [rng.standard_normal((n, 8)).astype(np.float32) for n in (2, 3, 40)]
    ids = [np.array([2, 9]), np.array([1, 5, 7]), np.arange(40)]

    def run(p, name):
        pool = mkpool(p, backend, tmp_path, name)
        reg, _ = seed_mirror(p, pool)
        ring = p.Ring(p.Alloc(pool), max_logs=4)
        for step, (i, r) in enumerate(zip(ids, new, strict=True)):
            ring.log_and_apply(step, reg, i, r)
        ro = p.open_ring(pool, max_logs=4, readonly=True)
        out = [ring.read_many([0, 2, 7]), ring.committed_after(0),
               ro.committed_after(-1), ring.committed_steps()]
        if name == "port":   # the port's readonly ring also refuses writes
            with pytest.raises(TenantIsolationError):
                ro.log_and_apply(3, reg, np.array([0]), new[0][:1])
            with pytest.raises(TenantIsolationError):
                ro.gc(10)
        return out, counters(pool.metrics)

    got = both(run)
    (pm, pa, pro, psteps), (jm, ja, jro, jsteps) = got["port"][0], got["jax"][0]
    assert psteps == jsteps == [0, 1, 2]
    for p_, j_ in ((pm, jm), (pa, ja), (pro, jro)):
        assert sorted(p_) == sorted(j_)
        for s in p_:
            for a, b in zip(p_[s][:2], j_[s][:2], strict=True):
                assert_same_bits(a, b)
    assert sorted(pm) == [0, 2] and sorted(pa) == [1, 2]
    assert_same_bits(pa[2][0], ids[2].astype(np.int64))
    assert got["port"][1] == got["jax"][1]


def test_readonly_local_allocator_guards():
    """tests/test_serve.py:243 in both packages, plus a domain free and
    ``JsonRegion.create`` (a reopen passes, a new region is refused)."""
    for p in PKGS.values():
        pool = p.Dram(1 << 18)
        rw = p.Alloc(pool)
        rw.domain("d").alloc("x", shape=(4,), dtype="float32")
        p.Json.create(rw.domain("m"), "meta", nbytes=1 << 10).write({"a": 1})
        ro = p.Alloc(pool, readonly=True)
        assert ro.domain("d").get("x") is not None
        assert p.Json.create(ro.domain("m"), "meta", nbytes=1 << 10).read() \
            == {"a": 1}
        with pytest.raises(p.Isolation):
            ro.domain("d").alloc("y", shape=(4,), dtype="float32")
        with pytest.raises(p.Isolation):
            ro.domain("d").free_region("x")
        with pytest.raises(p.Isolation):
            ro.free_domain("d")
        with pytest.raises(p.Isolation):
            ro.domain("d").free()
        with pytest.raises(p.Isolation):
            p.Json.create(ro.domain("m"), "other")
        assert rw.domain("d").free()
        assert rw.domain("d").get("x") is None


# -- cache and batcher ----------------------------------------------------------

def test_hot_row_cache_lru_and_counters():
    """tests/test_serve.py:60 in both packages: the same hits, misses,
    evictions and counters."""
    def run(p, _):
        m = p.Metrics(device_name="serve")
        c = p.Cache(2, metrics=m)
        c.put_many([1, 2], np.ones((2, 4), np.float32))
        hits, missing = c.get_many([1, 2, 3])
        out = [sorted(hits), missing]
        c.put_many([3], np.ones((1, 4)))
        out.append(len(c))
        out.append(c.get_many([1])[1])
        out.append(c.invalidate([2, 99]))
        out.append(c.clear())
        return out, counters(m)

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [[1, 2], [3], 2, [1], 1, 1]
    assert got["port"][1][5:8] == (2, 2, 2)


def test_batcher_dedup_one_gather():
    """tests/test_serve.py:76 in both packages: one deduplicated gather a
    batch, then a batch served from the cache alone."""
    def run(p, _):
        calls = []

        def gather(idx):
            calls.append(np.array(idx))
            return np.asarray(idx, np.float32)[:, None] * np.ones(4, np.float32)

        b = p.Batcher(gather, p.Cache(64))
        out = b.lookup_batch([np.array([5, 3, 5]), np.array([[3, 7], [7, 5]])])
        again = b.lookup_batch([np.array([3, 5, 7])])
        return out + again, [c.tolist() for c in calls]

    got = both(run)
    for a, b in zip(got["port"][0], got["jax"][0], strict=True):
        assert_same_bits(a, b)
    assert got["port"][1] == got["jax"][1] == [[3, 5, 7]]
    assert got["port"][0][1].shape == (2, 2, 4)


def test_batcher_view_path_bit_identical_to_jax(rng):
    """tests/test_serve.py:95: mixed hot and cold batches, an empty
    request; every block bitwise the JAX package's and ``table[ids]``, the
    cached rows read-only views of a shared block."""
    table = rng.standard_normal((64, 8)).astype(np.float32)
    batches = [
        [np.array([1, 2, 3])],
        [np.array([1, 2]), np.array([2, 3])],
        [np.array([[1, 9], [2, 40]]), np.array([9, 1, 63])],
        [np.array([], dtype=np.int64), np.array([5])],
    ]

    def run(p, _):
        b = p.Batcher(lambda idx: table[np.asarray(idx, np.int64)], p.Cache(32))
        out = [b.lookup_batch(reqs) for reqs in batches]
        hits, _ = b.cache.get_many([1, 2])
        assert all(h.base is not None and not h.flags.writeable
                   for h in hits.values())
        return out

    got = both(run)
    for reqs, pb, jb in zip(batches, got["port"], got["jax"], strict=True):
        for r, a, b in zip(reqs, pb, jb, strict=True):
            assert_same_bits(a, b)
            assert a.tobytes() == table[r.astype(np.int64)].tobytes()


def test_commit_hook_invalidates_inline():
    """tests/test_serve.py:187 in both packages."""
    def run(p, _):
        cache = p.Cache(8)
        cache.put_many([1, 2, 3], np.ones((3, 4), np.float32))
        tailer = types.SimpleNamespace(watermark=-1)
        p.hook(cache, tailer)(5, np.array([2, 7]))
        return len(cache), tailer.watermark, cache.get_many([2])[1]

    got = both(run)
    assert got["port"] == got["jax"] == (2, 5, [2])


# -- the serving tier -------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_sees_committed_rows_exact_invalidation(backend, tmp_path):
    """tests/test_serve.py:143 in both packages: a commit evicts exactly
    the cached rows it touched and the next batch serves the new rows;
    rows, poll results and counters bitwise the JAX package's."""
    def run(p, name):
        pool = mkpool(p, backend, tmp_path, name)
        reg, rows = seed_mirror(p, pool)
        ring = p.Ring(p.Alloc(pool), max_logs=8)
        tier = p.Tier(pool, cache_rows=32)
        out = [tier.serve_batch([np.array([1, 2, 3]), np.array([2, 3, 4])])]
        misses = tier.metrics.cache_misses
        new = np.full((2, 8), 42.0, np.float32)
        ring.log_and_apply(0, reg, np.array([2, 9]), new)
        info = tier.poll_coherence()
        out.append(tier.serve_batch([np.array([2, 9, 1])]))
        s = tier.stats()
        stats = {k: s[k] for k in ("requests", "rows", "hit_rate",
                                   "cache_hits", "cache_misses",
                                   "invalidations", "watermark", "wire")}
        return out, misses, info, stats, counters(tier.metrics), \
            counters(pool.metrics), rows

    got = both(run)
    (pout, pmiss, pinfo, pstats, ptier, ppool, rows) = got["port"]
    (jout, *jrest) = got["jax"]
    for pb, jb in zip(pout, jout, strict=True):
        for a, b in zip(pb, jb, strict=True):
            assert_same_bits(a, b)
    assert [pmiss, pinfo, pstats, ptier, ppool] == jrest[:5]
    assert pmiss == 4 and pinfo == {"steps": 1, "evicted": 1, "watermark": 0}
    assert_same_bits(pout[0][0], rows[[1, 2, 3]])
    assert (pout[1][0][:2] == 42.0).all()
    assert_same_bits(pout[1][0][2], rows[1])
    assert pstats["invalidations"] == 1 and pstats["wire"] == {}


@pytest.mark.parametrize("backend", BACKENDS)
def test_tailer_follows_ring_growth(backend, tmp_path):
    """tests/test_serve.py:169 in both packages: the tailer rebinds to the
    ring's new generation after a grow; the same polls and counters."""
    def run(p, name):
        pool = mkpool(p, backend, tmp_path, name)
        reg, _ = seed_mirror(p, pool)
        ring = p.Ring(p.Alloc(pool), max_logs=4)
        tier = p.Tier(pool, cache_rows=32)
        tier.serve_batch([np.arange(8)])
        ring.log_and_apply(0, reg, np.array([1]), np.zeros((1, 8), np.float32))
        polls = [tier.poll_coherence()]
        big = np.arange(48)
        ring.log_and_apply(1, reg, big, np.zeros((big.size, 8), np.float32))
        polls.append(tier.poll_coherence())
        return polls, tier.tailer.ring.gen, counters(tier.metrics)

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0][0]["steps"] == 1
    assert got["port"][0][1]["watermark"] == 1 and got["port"][1] == 1


def test_tier_before_the_trainer_and_without_a_mirror(tmp_path):
    """Serving may come up before the trainer's first commit: the tailer
    attaches at the next batch. With no mirror region the tier raises
    ``PoolError``, as the JAX package's does. A tier asked for a replica
    takes a ``ReplicaReader`` over the pool, not ready while no replica
    exists (the failover itself: ``tests/test_torch_sharded_pool.py`` and
    the serve_batched sharded drill)."""
    pool = DramPool(1 << 18)
    with pytest.raises(PoolError, match="embedding-mirror/rows"):
        EmbeddingServeTier(pool).serve_batch([np.array([1])])
    reg, rows = seed_mirror(PKGS["port"], pool)
    tier = EmbeddingServeTier(pool, cache_rows=16)
    assert tier.tailer is None
    tier.serve_batch([np.array([3, 4])])
    ring = UndoRing(PoolAllocator(pool), max_logs=4)
    ring.log_and_apply(0, reg, np.array([3]), np.ones((1, 8), np.float32))
    got = tier.serve_batch([np.array([3, 4])])[0]
    assert tier.tailer is not None and tier.metrics.cache_invalidations == 1
    assert (got[0] == 1).all() and got[1].tobytes() == rows[4].tobytes()
    tier = EmbeddingServeTier(pool, replica=True)
    assert tier.replica is not None and not tier.replica.ready
    assert tier.staleness_bound() == 0 and tier.stats()["failovers"] == 0


def test_commit_during_a_gather_leaves_no_stale_row(rng):
    """A serving thread gathers a row; before it caches the row, the
    trainer's writer thread applies a commit to the mirror and its commit
    hook evicts the row. The pre-commit row must not enter the cache after
    that eviction: the next batch serves the committed row. (The JAX
    package's tier caches the pre-commit row and keeps serving it.)"""
    def run(p):
        pool = p.Dram(1 << 18)
        reg, rows = seed_mirror(p, pool)
        tier = p.Tier(pool, cache_rows=32)
        hook = p.hook(tier.cache, tier.tailer)
        new = np.full((2, 8), 7.0, np.float32)
        gather = tier.batcher.gather

        def gather_then_commit(idx):
            got = gather(idx)                       # the pre-commit rows
            if 5 in idx:
                p.Nmp(pool).row_update(reg, np.array([5, 9]), new)
                hook(0, np.array([5, 9]))           # on the writer thread
            return got

        tier.batcher.gather = gather_then_commit
        first = tier.serve_batch([np.array([4, 5])])[0]
        tier.batcher.gather = gather
        return first, tier.serve_batch([np.array([4, 5, 9])])[0], rows

    first, after, rows = run(PKGS["port"])
    assert_same_bits(first, rows[[4, 5]])         # served before the commit
    assert (after[1:] == 7.0).all()               # the committed rows
    assert_same_bits(after[0], rows[4])
    jfirst, jafter, _ = run(PKGS["jax"])
    assert_same_bits(jfirst, first)
    assert_same_bits(jafter[1], rows[5])          # the reference's stale row


def test_cache_fill_keeps_rows_invalidated_before_its_epoch():
    """``put_many(since=e)`` drops only the ids invalidated after epoch e;
    a fill older than the remembered invalidations, or than a clear, keeps
    nothing."""
    rows = np.ones((3, 4), np.float32)
    c = HotRowCache(8)
    e = c.epoch
    c.invalidate([1])
    late = c.epoch
    c.invalidate([2])
    c.put_many([1, 2, 3], rows, since=late)
    assert sorted(c._rows) == [1, 3]
    c.put_many([4, 5], rows[:2], since=e)           # 2 and 1 were dropped
    assert sorted(c._rows) == [1, 3, 4, 5]
    e = c.epoch
    for i in range(100):
        c.invalidate([1000 + i])
    c.put_many([6], rows[:1], since=e)
    e = c.epoch
    c.clear()
    c.put_many([7], rows[:1], since=e)
    assert len(c) == 0


def test_tier_retries_the_tailer_only_when_the_directory_changed(monkeypatch):
    """Without an undo ring each batch looks the ring's meta up in the
    pool's directory, and parses the directory only when it changed; the
    tailer attaches at the first batch after the ring appears."""
    from repro_torch.pool import allocator as al
    pool = DramPool(1 << 18)
    reg, _ = seed_mirror(PKGS["port"], pool)
    tier = EmbeddingServeTier(pool, cache_rows=16)
    parses = []
    loads = al.json.loads
    monkeypatch.setattr(al.json, "loads",
                        lambda b: parses.append(1) or loads(b))
    for _ in range(3):
        tier.serve_batch([np.array([3])])
    assert tier.tailer is None and parses == []
    UndoRing(PoolAllocator(pool), max_logs=4).log_and_apply(
        0, reg, np.array([3]), np.ones((1, 8), np.float32))
    tier.serve_batch([np.array([3])])
    assert tier.tailer is not None and tier.metrics.cache_invalidations == 1


def test_tier_bag_lookup_and_pool_serve_fns(tmp_path, rng):
    """``bag_lookup`` reduces pool-side past the cache; on a stacked (T, R,
    d) region the port adds the tables' row offsets. ``make_pool_serve_fns``
    closes over the tier."""
    pool = DramPool(1 << 20)
    tabs = rng.standard_normal((3, 16, 8)).astype(np.float32)
    reg = PoolAllocator(pool).domain("embedding-mirror").alloc(
        "rows", shape=tabs.shape, dtype="float32")
    reg.write_array(tabs)
    tier = EmbeddingServeTier(pool, cache_rows=8)
    ids = rng.integers(0, 16, (2, 3, 4))
    want = tabs[np.arange(3)[None, :, None], ids].sum(2)
    lookup, bag_lookup, serve_batch = make_pool_serve_fns(tier)
    np.testing.assert_allclose(bag_lookup(ids), want, rtol=1e-6)
    assert tier.metrics.cache_hits + tier.metrics.cache_misses == 0
    assert_same_bits(lookup([1, 2])[0], tabs[0, 1])
    assert_same_bits(serve_batch([[20], [47]])[1][0], tabs[2, 15])


# -- the pool strategy of embedding_ops ------------------------------------------

def test_embedding_ops_pool_mode(tmp_path, rng):
    """tests/test_pool.py:580 through the port: the pool route equals
    ``table[ids]`` and the JAX package's route, bitwise; without a mirror
    it raises RuntimeError."""
    tab = rng.standard_normal((64, 8)).astype(np.float32)
    ids = np.array([[1, 5], [63, 0]], dtype=np.int32)
    jdev, dev = JDramPool(1 << 20), DramPool(1 << 20)
    jeo.attach_pool(JMirror(jdev, tab))
    eo.attach_pool(EmbeddingPoolMirror(dev, tab))
    try:
        want = np.asarray(jeo.lookup(jnp.asarray(tab), jnp.asarray(ids),
                                     mode="pool"))
        got = eo.lookup(torch.from_numpy(tab), torch.from_numpy(ids),
                        mode="pool")
        assert_same_bits(got.numpy(), want)
        assert_same_bits(got.numpy(), tab[ids])
        assert dev.metrics.link_bytes() == jdev.metrics.link_bytes() > 0
        with eo.lookup_mode("pool"):       # the thread-local mode
            assert eo.current_mode() == "pool"
            assert torch.equal(eo.lookup(torch.from_numpy(tab),
                                         torch.from_numpy(ids)), got)
        assert eo.current_mode() == "auto"
        assert eo.pool_mirror() is not None
    finally:
        jeo.detach_pool()
        eo.detach_pool()
    with pytest.raises(RuntimeError, match="attach_pool"):
        eo.lookup(torch.from_numpy(tab), torch.from_numpy(ids), mode="pool")
    with pytest.raises(RuntimeError, match="attach_pool"):
        eo.bag_lookup(torch.from_numpy(tab.reshape(4, 16, 8)),
                      torch.zeros((1, 4, 2), dtype=torch.int32), mode="pool")


def test_embedding_ops_pool_bag_and_update(tmp_path, rng):
    """tests/test_pool.py:603 through the port: the bags equal the JAX
    package's route bitwise and the plain sum within 1e-5; the bf16 tables'
    bags are the f32 bags rounded once; ``apply_grad`` updates pool-side."""
    tabs = rng.standard_normal((4, 16, 8)).astype(np.float32)
    ids = rng.integers(0, 16, (3, 4, 5)).astype(np.int32)
    jdev, dev = JDramPool(1 << 20), DramPool(1 << 20)
    jeo.attach_pool(JMirror(jdev, tabs))
    mir = EmbeddingPoolMirror(dev, tabs)
    eo.attach_pool(mir)
    try:
        want = np.asarray(jeo.bag_lookup(jnp.asarray(tabs), jnp.asarray(ids),
                                         mode="pool"))
        got = eo.bag_lookup(torch.from_numpy(tabs), torch.from_numpy(ids),
                            mode="pool")
        assert_same_bits(got.numpy(), want)
        flat = (ids + np.arange(4)[None, :, None] * 16).reshape(-1)
        ref = tabs.reshape(64, 8)[flat].reshape(3, 4, 5, 8).sum(2)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
        kern = eo.bag_lookup(torch.from_numpy(tabs), torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), kern.numpy(), rtol=1e-5,
                                   atol=1e-6)
        half = eo.bag_lookup(torch.from_numpy(tabs).bfloat16(),
                             torch.from_numpy(ids), mode="pool")
        assert half.dtype == torch.bfloat16 and torch.equal(half, got.bfloat16())
        grad = np.ones((2, 8), np.float32)
        before = mir.region.read_array().reshape(64, 8)[[0, 1]].copy()
        mir.apply_grad(np.array([0, 1]), grad, lr=0.5)
        after = mir.region.read_array().reshape(64, 8)[[0, 1]]
        np.testing.assert_allclose(after, before - 0.5 * grad, rtol=1e-6)
    finally:
        jeo.detach_pool()
        eo.detach_pool()


def test_pool_route_raises_under_grad(rng):
    """No gradient reaches the table through the host: with grad on and a
    table that needs one, both lookups raise; under no_grad they read."""
    tab = torch.from_numpy(rng.standard_normal((4, 16, 8)).astype(np.float32))
    eo.attach_pool(EmbeddingPoolMirror(DramPool(1 << 20), tab.numpy()))
    try:
        ids = torch.zeros((2, 4, 3), dtype=torch.int32)
        row_tab = tab.reshape(64, 8).clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no gradient"):
            eo.lookup(row_tab, ids[:, 0], mode="pool")
        with pytest.raises(RuntimeError, match="no gradient"):
            eo.bag_lookup(tab.clone().requires_grad_(), ids, mode="pool")
        with torch.no_grad():
            got = eo.bag_lookup(tab.clone().requires_grad_(), ids, mode="pool")
            rows = eo.lookup(row_tab, ids[:, 0], mode="pool")
        assert torch.equal(got, eo.bag_lookup(tab, ids))   # 3 x row 0 each
        assert torch.equal(rows, tab[0, :1].expand(2, 3, 8))
    finally:
        eo.detach_pool()


def test_flat_mirror_bag_lookup_reference_wrong_rows_port_raises(rng):
    """The JAX package's tier passes stacked (B, T, L) ids to ``bag_gather``
    without per-table offsets, so over the checkpoint manager's flat (T*R,
    d) mirror its pool-route bags read table 0's rows for every table. The
    port's route raises for a mirror that is not (T, R, d)."""
    T, R, d = 3, 16, 8
    tabs = rng.standard_normal((T, R, d)).astype(np.float32)
    ids = rng.integers(1, R, (2, T, 5)).astype(np.int32)
    right = tabs[np.arange(T)[None, :, None], ids].sum(2)
    table0 = tabs[0][ids].sum(2)

    def flat_tier(p):
        pool = p.Dram(1 << 20)
        reg = p.Alloc(pool).domain("embedding-mirror").alloc(
            "rows", shape=(T * R, d), dtype="float32")
        reg.write_array(tabs.reshape(T * R, d))
        return p.Tier(pool)

    jeo.attach_pool(flat_tier(PKGS["jax"]))
    try:
        got = np.asarray(jeo.bag_lookup(jnp.asarray(tabs), jnp.asarray(ids),
                                        mode="pool"))
    finally:
        jeo.detach_pool()
    np.testing.assert_allclose(got, table0, rtol=1e-6)   # the wrong rows
    assert not np.allclose(got[:, 1:], right[:, 1:])
    eo.attach_pool(flat_tier(PKGS["port"]))
    try:
        with pytest.raises(ValueError, match="flat mirror"):
            eo.bag_lookup(torch.from_numpy(tabs), torch.from_numpy(ids),
                          mode="pool")
    finally:
        eo.detach_pool()


# -- smoke LM serving through the pool ----------------------------------------------

def _jax_logits(jcfg, jparams, prompt, num_new, max_seq):
    """The JAX package's greedy loop (``greedy_generate``'s), keeping the
    logits behind each token."""
    prefill_step, decode_step, init_cache = jax_make_serve_fns(jcfg)
    B, S = prompt.shape
    logits, caches = jax.jit(prefill_step)(jparams, {"tokens": prompt},
                                           init_cache(B, max_seq))
    dec, kept = jax.jit(decode_step), [logits]
    for t in range(num_new - 1):
        tok = jnp.argmax(logits, axis=-1)[:, None]
        logits, caches = dec(jparams, tok, jnp.asarray(S + t), caches, {})
        kept.append(logits)
    return np.stack([np.asarray(x) for x in kept], axis=1)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_pool_serving_matches_jax_and_device_gather(arch, tmp_path):
    """Smoke generation with every token lookup served from a pmem pool
    mirror through the tier: tokens equal to the JAX package's
    ``greedy_generate`` under its own ``pool_serving``, logits within 1e-4
    of its loop's; tokens and logits bitwise the port's own run through
    the row-gather route; the tiers' lookups, hits and misses equal."""
    jcfg = jax_get_arch(arch, smoke=True).model
    cfg = get_arch(arch, smoke=True).model
    jparams = jax_get_api(jcfg).init(jax.random.PRNGKey(0), jcfg)
    params = interop.params_from_numpy(jparams, CPU)
    prompt = JaxLMBatches(jcfg, 2, 8).next(0)["tokens"]
    table = np.asarray(jparams["embed"]["table"], np.float32)
    jpool = JPmemPool(str(tmp_path / "jax.img"), 1 << 20)
    reg = JPoolAllocator(jpool).domain("embedding-mirror").alloc(
        "rows", shape=table.shape, dtype="float32")
    reg.write_array(table)
    reg.persist(point="mirror-load")
    jtier = JTier(jpool)
    with jax_pool_serving(jtier):
        want = np.asarray(jax_greedy_generate(jcfg, jparams, prompt, 4,
                                              max_seq=16))
        want_logits = _jax_logits(jcfg, jparams, prompt, 4, 16)
    os.makedirs(tmp_path / "port")
    tier = build_tier(params["embed"]["table"], "pmem",
                      pool_dir=str(tmp_path / "port"))
    stats, plain = {}, {}
    with pool_serving(tier):
        got = greedy_generate(cfg, params, torch.from_numpy(np.array(prompt)),
                              4, max_seq=16, stats=stats)
    gathered = greedy_generate(cfg, params, torch.from_numpy(np.array(prompt)),
                               4, max_seq=16, stats=plain)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(stats["logits"].numpy(), want_logits,
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, gathered)
    assert torch.equal(stats["logits"], plain["logits"])
    s, js = tier.stats(), jtier.stats()
    # the JAX tier served the generation twice (its loop and greedy_generate)
    assert (2 * s["requests"], 2 * s["rows"]) == (js["requests"], js["rows"])
    assert s["requests"] == 4 and s["cache_misses"] > 0
    assert s["cache_hits"] + s["cache_misses"] <= s["rows"]
    tier.pool.close()
    jpool.close()


# -- a smoke DLRM trained into a pmem pool, served while it trains ------------------

def test_dlrm_trained_into_pmem_pool_served_by_both_tiers(tmp_path, rng):
    """The port trains smoke dlrm-rm1 relaxed, checkpointing every step into
    a pmem pool. The port's tier is attached to the manager's pool and kept
    coherent by ``add_commit_hook``: after each commit the invalidations
    equal exactly the cached touched rows, and the rows served (the
    touched ids and some untouched) equal the tables bitwise. Afterwards
    the port's and the JAX package's tiers read the pool file back, bitwise
    equal to the final tables."""
    cfg = get_arch("dlrm-rm1", smoke=True).model
    cc = CheckpointConfig(directory=str(tmp_path / "ck"), dense_interval=0,
                          pool_backend="pmem")
    tc = TrainConfig(embed_learning_rate=0.05, checkpoint=cc)
    state = train_loop.init_state(cfg, tc, "cpu")
    mgr = CheckpointManager(cfg, cc, embed_init=state["embed"])
    tier = EmbeddingServeTier(mgr.pool, cache_rows=256)
    seen = []
    mgr.add_commit_hook(lambda step, idx: seen.append((step, idx.size)))
    mgr.add_commit_hook(make_commit_hook(tier.cache, tier.tailer))
    d = state["embed"]["emb_tables"].shape[-1]
    n_rows = state["embed"]["emb_tables"].numel() // d
    log = []
    tier.serve_batch([rng.integers(0, n_rows, 300)])   # a warm cache
    on_step = mgr.on_step

    def checked(step, st, feed):
        _, idx = touched_rows(feed)
        expect = sum(1 for i in idx if i in tier.cache)
        before = tier.metrics.cache_invalidations
        on_step(step, st, feed)
        mgr.flush()
        other = np.setdiff1d(rng.integers(0, n_rows, 64), idx)
        rows = tier.serve_batch([idx, other])
        flat = st["embed"]["emb_tables"].reshape(-1, d)
        for ids, got in zip((idx, other), rows, strict=True):
            assert_same_bits(got, flat[torch.from_numpy(ids)].float().numpy())
        log.append((tier.metrics.cache_invalidations - before, expect))
    mgr.on_step = checked
    state, _ = train_loop.train(cfg, tc, make_batches(cfg, 4, 16, seed=3,
                                                      device="cpu"),
                                3, relaxed=True, state=state, device="cpu",
                                ckpt_manager=mgr)
    assert [s for s, _ in seen] == [0, 1, 2]
    assert all(got == want for got, want in log) and sum(w for _, w in log) > 0
    assert tier.stats()["watermark"] == 2 and tier.poll_coherence()["steps"] == 0
    mgr.close()
    final = state["embed"]["emb_tables"].reshape(-1, d).numpy()
    path = str(tmp_path / "ck" / "pool.img")
    ids = np.arange(n_rows)
    for p in PKGS.values():
        pool = p.Pmem.open(path)
        assert_same_bits(p.Tier(pool).serve_batch([ids])[0], final)
        pool.close()


# -- the serve CLI ---------------------------------------------------------------------

def _serve(*args):
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--device", "cpu", "--new-tokens", "4", *args],
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_cli_pool_backend(backend, tmp_path):
    """``launch.serve --pool-backend`` serves the same tokens as the
    row-gather route and prints the tier's stats; a pmem image lands in
    ``--pool-dir``."""
    plain = _serve()
    extra = ["--pool-dir", str(tmp_path)] if backend == "pmem" else []
    pooled = _serve("--pool-backend", backend, *extra)
    assert plain.returncode == 0 and pooled.returncode == 0, pooled.stderr
    sample = [ln for ln in plain.stdout.splitlines() if "sample" in ln]
    assert sample and sample == [ln for ln in pooled.stdout.splitlines()
                                 if "sample" in ln]
    assert f"pool tier ({backend}): 6 lookups" in pooled.stdout
    if backend == "pmem":
        assert os.listdir(tmp_path) == ["pool.img"]


def test_build_tier_writes_the_table_in_chunks(monkeypatch, tmp_path):
    """The f32 mirror is written a bounded chunk at a time, and reads back
    bitwise as the bf16 table widened."""
    import repro_torch.launch.serve as serve_cli
    monkeypatch.setattr(serve_cli, "_LOAD_BYTES", 3 * 4 * 16)
    table = torch.randn((10, 16)).bfloat16()
    tier = build_tier(table, "pmem", pool_dir=str(tmp_path))
    writes = tier.pool.metrics.media["mirror-load"].ops
    assert writes == 4                    # rows 0-2, 3-5, 6-8, 9
    got = tier.serve_batch([np.arange(10)])[0]
    assert_same_bits(got, table.float().numpy())
    tier.pool.close()
