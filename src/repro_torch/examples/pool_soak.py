"""Bounded fault-injection soak drill (counterpart of the JAX package's
``examples/pool_soak.py``: the same cells, options, schedules and report).

For each (backend, seed) cell: arm a ``FaultSchedule.seeded`` schedule (kind
crash / torn / drop chosen by the seed) over the standard persist barriers,
train smoke tinyllama on the relaxed schedule with the two-tier checkpoint
manager, then:

  * crash / torn schedules fire an ``InjectedCrash`` mid-run: the device is
    power-cycled, recovery must succeed, and resuming must reproduce the
    uninterrupted reference run's losses (the durability contract);
  * drop schedules lie silently (a missed clwb/fence): training completes;
    recovery must still come back consistent from the *live* pool and the
    drill asserts the dropped flush was counted;

and record the pool-metrics snapshot. The remote backend runs the same drill
through a live memory node in the process (faults armed over the wire), so
the whole protocol path soaks too; the sharded backend spreads the
checkpoint domains over ``--shards`` pmem-backed memory nodes and arms the
schedule on every node. ``--migrations``, ``--serve`` and ``--node-loss``
add the sharded pool's migrate-under-fire, serve-under-fire and
permanent-node-loss cells. Results land in a JSON report; any cell failure
exits non-zero. With ``REPRO_POOL_CHECK=1`` every pool the trainer and
recovery open runs under the crash-consistency checker.

Training runs on ``cuda`` (the flash, bag, gather and row-update kernels)
unless ``--device cpu`` is given; it raises when there is no card.

    PYTHONPATH=src python -m repro_torch.examples.pool_soak \\
        --backends pmem,remote,sharded --shards 2 --seeds 4 \\
        [--migrations N] [--serve N] [--node-loss N] [--device cpu] \\
        --out soak_metrics.json
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import traceback

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import make_batches
from repro_torch.pool import (FaultSchedule, InjectedCrash, PmemPool,
                              PoolError)
from repro_torch.pool.server import PoolServer
from repro_torch.training import train_loop

POINTS = ("undo-payload", "undo-commit", "mirror-apply", "manifest-advance",
          "dense-blob")
KINDS = ("crash", "torn", "drop")
STEPS = 12


def build_ctx(device):
    b = get_arch("tinyllama-1.1b", smoke=True)
    cc0 = CheckpointConfig(directory="/unused", dense_interval=1)
    tc = TrainConfig(embed_learning_rate=0.05, checkpoint=cc0)
    data = make_batches(b.model, 4, 16, seed=3, device=device)
    _, full_losses = train_loop.train(b.model, tc, data, STEPS, relaxed=True,
                                      device=device)
    return b, tc, data, device, full_losses


def _fresh(ctx):
    b, tc, _, device, _ = ctx
    return train_loop.init_state(b.model, tc, device)


def _train(ctx, steps, **kw):
    b, tc, data, device, _ = ctx
    return train_loop.train(b.model, tc, data, steps, relaxed=True,
                            device=device, **kw)


def _check_tail(ctx, rec, gap_bound=None):
    """Resume from ``rec`` and train to STEPS: with the dense tier caught up
    (gap 0) the losses must replay the uninterrupted run's; a crash inside
    tier-M legitimately leaves gap > 0 (the paper's relaxed window), where
    the deviation must stay bounded (Fig. 9a), never diverge."""
    full_losses = ctx[-1]
    st, resume = recovery.resume_train_state(rec, _fresh(ctx))
    n_tail = STEPS - resume
    if n_tail <= 0:
        return
    _, tail = _train(ctx, n_tail, state=st, start_step=resume)
    tail, ref = np.asarray(tail), np.asarray(full_losses[resume:])
    assert np.isfinite(tail).all(), "resumed losses diverged"
    if rec.gap == 0:
        np.testing.assert_allclose(tail, ref, rtol=1e-5, atol=1e-6)
    elif gap_bound is not None:
        assert rec.gap <= gap_bound
        rel = np.abs(tail - ref) / np.maximum(np.abs(ref), 1e-6)
        assert rel.max() < 0.05, \
            f"gap={rec.gap} deviation {rel.max():.3f} not bounded"


def _start_nodes(work, prefix, n):
    servers, addrs, imgs = [], [], []
    for i in range(n):
        imgs.append(os.path.join(work, f"{prefix}{i}.img"))
        servers.append(PoolServer(
            PmemPool(imgs[i], 1 << 22),
            "unix:" + os.path.join(work, f"{prefix}{i}.sock")).start())
        addrs.append(servers[i].addr)
    return servers, addrs, imgs


def one_cell(ctx, backend, seed, root, addr=None, shards=None):
    """Run one soak cell; returns a result dict (raises on assertion
    failure)."""
    b, tc = ctx[0], ctx[1]
    kind = KINDS[seed % len(KINDS)]
    # every < steps so each armed point is guaranteed to reach its
    # occurrence during the run (each POINTS barrier fires once per step
    # at dense_interval=1)
    faults = FaultSchedule.seeded(seed, POINTS, every=STEPS - 2, kind=kind)
    cc = CheckpointConfig(directory=root, dense_interval=1,
                          pool_backend=backend, pool_addr=addr or "",
                          pool_shards=",".join(shards or []),
                          pool_tenant=f"soak-{seed}")
    st0 = _fresh(ctx)
    mgr = CheckpointManager(b.model, cc, embed_init=st0["embed"],
                            faults=faults)
    crashed = False
    try:
        _train(ctx, STEPS, state=st0, ckpt_manager=mgr)
        mgr.flush()
    except InjectedCrash:
        crashed = True
    assert crashed == (kind != "drop"), \
        f"kind={kind} expected crash={kind != 'drop'}, got {crashed}"

    if crashed:
        mgr.pool.crash()                  # power-cycle the node
    rec = recovery.recover(root, pool=mgr.pool)
    # -1 is legal for a crash before the first COMMIT: recovery falls back
    # to the initial mirror and training replays from step 0
    assert rec.mirror_step >= -1, "no consistent state recovered"
    snap = mgr.pool.metrics.snapshot()

    if kind == "drop":
        # the schedule armed one drop per point; at least one barrier in
        # POINTS fired during the run and was eaten
        assert snap["dropped_flushes"] >= 1, "drop schedule never fired"
        assert rec.mirror_step == STEPS - 1
    else:
        _check_tail(ctx, rec, gap_bound=cc.dense_interval)
    mgr.pool.close()
    return {"backend": backend, "seed": seed, "kind": kind,
            "crashed": crashed, "mirror_step": rec.mirror_step,
            "dense_step": rec.dense_step, "rolled_back": rec.rolled_back,
            "metrics": snap}


def migration_cell(ctx, seed, work, nshards=2):
    """Seeded migrate-under-fire drill (one cell): train on an N-node
    sharded pool, then

      * phase A: live-migrate the embedding mirror and kill the SOURCE
        memory node mid-copy: the migration aborts before its flip, and
        recovery (after the node restarts over its pmem image) must find
        the domain on the source bitwise, with the partial destination
        copy reclaimed by the open-time sweep;
      * phase B: resume, migrate again and kill the DESTINATION node right
        after the epoch flip: the flip is durable, so recovery must find
        the domain on the destination bitwise (the import persisted before
        the flip), and training resumes exactly.
    """
    b, tc = ctx[0], ctx[1]
    servers, addrs, imgs = _start_nodes(work, "mig", nshards)
    root = os.path.join(work, "ck")
    cc = CheckpointConfig(directory=root, dense_interval=1,
                          pool_backend="sharded", pool_shards=",".join(addrs),
                          pool_tenant=f"mig-{seed}")
    try:
        st0 = _fresh(ctx)
        mgr = CheckpointManager(b.model, cc, embed_init=st0["embed"])
        _train(ctx, STEPS, state=st0, ckpt_manager=mgr)
        mgr.flush()
        oracle_a = np.array(mgr.mirror_rows)
        pool = mgr.pool
        src = pool.placement.place("embedding-mirror")
        dst = (src + 1 + seed) % nshards
        dst = dst if dst != src else (src + 1) % nshards

        def restart(i):
            servers[i].shutdown(close_device=True)
            servers[i] = PoolServer(PmemPool.open(imgs[i]), addrs[i]).start()

        # -- phase A: source node dies mid-copy (seeded occurrence) --------
        state = {"left": seed % 2 + 1}

        def kill_src(point):
            if point == "migrate.mid-copy":
                state["left"] -= 1
                if state["left"] == 0:
                    servers[src].shutdown(close_device=True)

        pool.migrate_window_hook = kill_src
        crashed = False
        try:
            pool.migrate_domain("embedding-mirror", dst)
        except PoolError:
            crashed = True
        assert crashed, "source kill mid-copy must abort the migration"
        pool.close()
        restart(src)
        rec = recovery.recover(root)
        assert rec.pool.placement.place("embedding-mirror") == src, \
            "crash before the flip must leave the domain on the source"
        assert rec.mirror_step == STEPS - 1
        np.testing.assert_array_equal(rec.embed_rows, oracle_a)
        assert "embedding-mirror" not in rec.pool.shard_domains(dst), \
            "partial destination copy survived the open-time sweep"

        # -- phase B: resume, then the destination dies post-flip ----------
        st, resume = recovery.resume_train_state(rec, _fresh(ctx))
        mgr2 = CheckpointManager(b.model, cc, pool=rec.pool)
        mgr2.init_mirror(st["embed"], step=rec.mirror_step)
        _train(ctx, 2, state=st, start_step=resume, ckpt_manager=mgr2)
        mgr2.flush()
        oracle_b = np.array(mgr2.mirror_rows)
        pool2 = mgr2.pool

        def kill_dst(point):
            if point == "migrate.post-flip-pre-gc":
                servers[dst].shutdown(close_device=True)

        pool2.migrate_window_hook = kill_dst
        info = pool2.migrate_domain("embedding-mirror", dst)
        assert info["epoch"] >= 1 and "undo-log" in info["moved"]
        pool2.close()
        restart(dst)
        rec2 = recovery.recover(root)
        assert rec2.pool.placement.place("embedding-mirror") == dst, \
            "crash after the flip must land the domain on the destination"
        np.testing.assert_array_equal(rec2.embed_rows, oracle_b)
        assert "embedding-mirror" not in rec2.pool.shard_domains(src), \
            "stale source copy leaked past GC + sweep"
        # bitwise resume: the tail replays the uninterrupted run
        _check_tail(ctx, rec2)
        snap = rec2.pool.metrics.snapshot()
        rec2.pool.close()
        return {"backend": "sharded-migrate", "seed": seed,
                "kind": "migrate-under-fire", "crashed": True,
                "mirror_step": rec2.mirror_step,
                "dense_step": rec2.dense_step,
                "rolled_back": rec2.rolled_back,
                "migrate_epoch": info["epoch"],
                "migrate_link_bytes": info["link_bytes"],
                "migrate_raw_bytes": info["raw_bytes"],
                "metrics": snap}
    finally:
        for server in servers:
            server.shutdown(close_device=True)


def serve_cell(ctx, seed, work, nshards=2):
    """Seeded serve-under-fire drill (one cell): train on an N-node sharded
    pool with a commit-refreshed read replica while a pool-backed serving
    tier (``repro_torch.serve``) reads the live mirror in the same process:

      * every tier-E commit fires a hook that serves the freshly touched
        rows back through the cached tier and asserts they equal the
        mirror (serve-after-commit coherence under real training);
      * after training, the PRIMARY memory node is killed: the tier must
        fail reads over to the replica shard and keep returning exact
        values within the configured staleness bound;
      * the node restarts over its pmem image, recovery reopens the
        topology, and a fresh tier's reads must match the recovered mirror
        bitwise.
    """
    from repro_torch.pool.placement import PlacementMap
    from repro_torch.serve import (EmbeddingServeTier, ReplicaReader,
                                   make_commit_hook)

    b, tc = ctx[0], ctx[1]
    rng = np.random.default_rng(100 + seed)
    servers, addrs, imgs = _start_nodes(work, "srv", nshards)
    primary = PlacementMap(shards=tuple(addrs)).place("embedding-mirror")
    dst = (primary + 1) % nshards
    root = os.path.join(work, "ck")
    cc = CheckpointConfig(directory=root, dense_interval=1,
                          pool_backend="sharded", pool_shards=",".join(addrs),
                          pool_tenant=f"serve-{seed}",
                          pool_replica=dst, pool_replica_every=1)
    try:
        st0 = _fresh(ctx)
        mgr = CheckpointManager(b.model, cc, embed_init=st0["embed"])
        assert mgr.pool.placement.place("embedding-mirror") == primary
        nrows = mgr.mirror_region.shape[0]
        tier = EmbeddingServeTier(mgr.pool, cache_rows=128)
        mgr.add_commit_hook(make_commit_hook(tier.cache, tier.tailer))
        served = {"batches": 0}

        def serve_probe(step, idx):
            # read back the rows this commit just touched (plus noise):
            # the cached tier must return the freshly applied values
            ids = np.concatenate([
                np.asarray(idx, np.int64)[:8],
                rng.integers(0, nrows, 8)]).astype(np.int64)
            out = tier.serve_batch([ids])[0]
            np.testing.assert_array_equal(out, mgr.mirror_rows[ids])
            served["batches"] += 1

        mgr.add_commit_hook(serve_probe)
        _train(ctx, STEPS, state=st0, ckpt_manager=mgr)
        mgr.flush()
        assert served["batches"] == STEPS
        assert mgr.stats["replica_refreshes"] == STEPS
        oracle = np.array(mgr.mirror_rows)
        pool = mgr.pool

        # -- kill the primary memory node: the replica keeps serving -------
        tier.replica = ReplicaReader(pool)
        ids = rng.integers(0, nrows, 32).astype(np.int64)
        np.testing.assert_array_equal(tier.serve_batch([ids])[0],
                                      oracle[ids])
        servers[primary].shutdown(close_device=True)
        tier.cache.clear()
        out = tier.serve_batch([ids])[0]
        np.testing.assert_array_equal(out, oracle[ids])
        assert tier.failovers >= 1, "primary kill never exercised failover"
        lag = tier.staleness_bound()
        assert lag <= cc.pool_replica_every, \
            f"staleness {lag} exceeds the declared bound"
        try:
            pool.close()
        except PoolError:
            pass

        # -- node restart + recovery: a fresh tier serves the exact mirror -
        servers[primary] = PoolServer(PmemPool.open(imgs[primary]),
                                      addrs[primary]).start()
        rec = recovery.recover(root)
        assert rec.mirror_step == STEPS - 1
        rtier = EmbeddingServeTier(rec.pool, cache_rows=128)
        got = rtier.serve_batch([ids])[0]
        np.testing.assert_array_equal(got, np.asarray(rec.embed_rows)[ids])
        np.testing.assert_array_equal(got, oracle[ids])
        snap = rec.pool.metrics.snapshot()
        stats = tier.stats()
        rec.pool.close()
        return {"backend": "sharded-serve", "seed": seed,
                "kind": "serve-under-fire", "crashed": True,
                "mirror_step": rec.mirror_step,
                "dense_step": rec.dense_step,
                "rolled_back": rec.rolled_back,
                "serve_batches": served["batches"] + 3,
                "failovers": stats["failovers"],
                "hit_rate": stats["hit_rate"],
                "invalidations": stats["invalidations"],
                "staleness_bound": lag,
                "metrics": snap}
    finally:
        for server in servers:
            server.shutdown(close_device=True)


def node_loss_cell(ctx, seed, work, nshards=3):
    """Seeded permanent-node-loss drill (one cell): train on a 3-node
    sharded pool with commit-coupled checkpoint replication and the 2-of-3
    manifest quorum armed, then kill the shard hosting the mirror and undo
    ring AND delete its backing image; the node never comes back:

      * the replica shard is promoted under the real domain names in ONE
        placement epoch (no wire traffic to the dead node);
      * recovery replays the shipped undo ring over the promoted copy and
        must land bitwise on the replication watermark's state;
      * the manifest majority survives the loss, and the resumed tail on
        the two survivors stays consistent with the reference run.
    """
    b, tc = ctx[0], ctx[1]
    src = seed % nshards                 # doomed: hosts mirror + undo ring
    dst = (src + 1) % nshards            # replica destination
    other = (src + 2) % nshards          # manifest primary + dense tier
    servers, addrs, imgs = _start_nodes(work, "loss", nshards)
    root = os.path.join(work, "ck")
    cc = CheckpointConfig(
        directory=root, dense_interval=1, pool_backend="sharded",
        pool_shards=",".join(addrs), pool_tenant=f"loss-{seed}",
        pool_placement=(f"embedding-mirror={src},manifest={other},"
                        f"dense={other}"),
        pool_replica=dst, pool_replica_every=2,
        pool_ckpt_replica=dst, pool_manifest_quorum=True)
    try:
        st0 = _fresh(ctx)
        mgr = CheckpointManager(b.model, cc, embed_init=st0["embed"])
        snaps = {}

        def snapshot(step, idx):
            snaps[step] = np.array(mgr.mirror_rows)

        mgr.add_commit_hook(snapshot)
        _train(ctx, STEPS, state=st0, ckpt_manager=mgr)
        mgr.flush()
        assert mgr.stats["ship_steps"] == STEPS, "a committed step unshipped"
        assert mgr.stats["ship_full_refreshes"] >= 1
        ship_bytes = mgr.stats["ship_link_bytes"]

        # the node is gone FOR GOOD: killed, image unlinked, never restarted
        servers[src].shutdown(close_device=True)
        os.unlink(imgs[src])
        try:
            mgr.pool.close()
        except PoolError:
            pass

        # survivors-only reopen; the promotion flip is ONE placement epoch,
        # made durable through the recovery-side placement sink
        pool = recovery.open_pool(root)
        assert pool.dead_shards() == [src], "dead-node census wrong"
        epoch0 = pool.placement.epoch
        pool.epoch_sink = lambda pm: recovery.record_placement(root, pool)
        info = pool.promote_replica("embedding-mirror")
        assert set(info["promoted"]) == {"embedding-mirror", "undo-log"}
        assert info["epoch"] == epoch0 + 1, "promotion took >1 epoch"
        assert all(d == dst for d in info["dst"].values())
        pool.close()

        rec = recovery.recover(root)
        # the replica was refreshed every 2 steps, so the watermark is the
        # last even step; the shipped undo ring rolled the overhang back
        assert rec.mirror_step == STEPS - 2, \
            f"expected watermark {STEPS - 2}, got {rec.mirror_step}"
        assert rec.rolled_back
        assert rec.pool.placement.place("embedding-mirror") == dst
        np.testing.assert_array_equal(
            np.asarray(rec.embed_rows), snaps[rec.mirror_step])

        # resume on the two survivors: the tail must stay consistent
        _check_tail(ctx, rec)
        snap = rec.pool.metrics.snapshot()
        rec.pool.close()
        return {"backend": "sharded-node-loss", "seed": seed,
                "kind": "node-loss", "crashed": True,
                "mirror_step": rec.mirror_step,
                "dense_step": rec.dense_step,
                "rolled_back": rec.rolled_back,
                "dead_shard": src,
                "promote_epoch": info["epoch"],
                "promoted": sorted(info["promoted"]),
                "ship_link_bytes": ship_bytes,
                "metrics": snap}
    finally:
        for server in servers:
            server.shutdown(close_device=True)


def _run_cell(label, seed, prefix, fn, describe, results, failures):
    work = tempfile.mkdtemp(prefix=prefix)
    try:
        cell = fn(work)
        results.append(cell)
        print(f"soak[{label} seed={seed}] OK: {describe(cell)}", flush=True)
    except Exception as e:
        traceback.print_exc()
        failures.append({"backend": label, "seed": seed,
                         "error": f"{type(e).__name__}: {e}"})
        print(f"soak[{label} seed={seed}] FAILED: {e}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _backend_cell(ctx, backend, seed, work, shards):
    servers, addr, addrs = [], None, None
    try:
        if backend == "remote":
            servers, addrs, _ = _start_nodes(work, "pool", 1)
            addr = addrs[0]
        elif backend == "sharded":
            # one pmem-backed memory node per shard: the seeded schedule
            # arms on EVERY node, so whichever shard owns the faulted
            # domain takes the hit while the others keep serving
            servers, addrs, _ = _start_nodes(work, "node", shards)
        return one_cell(ctx, backend, seed, os.path.join(work, "ck"), addr,
                        addrs if backend == "sharded" else None)
    finally:
        for server in servers:
            server.shutdown(close_device=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", default="pmem,remote")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--shards", type=int, default=2,
                    help="memory nodes per cell for the sharded backend")
    ap.add_argument("--migrations", type=int, default=0,
                    help="run N seeded migrate-under-fire cells (kill the "
                         "source node mid-copy, then the destination "
                         "post-flip, with bitwise resume asserts)")
    ap.add_argument("--serve", type=int, default=0,
                    help="run N seeded serve-under-fire cells (pool-backed "
                         "serving tier reads the live mirror during "
                         "training, primary node killed, replica must keep "
                         "serving within the staleness bound, recovery "
                         "reads bitwise)")
    ap.add_argument("--node-loss", type=int, default=0,
                    help="run N seeded permanent-node-loss cells (kill the "
                         "mirror+undo shard AND delete its image, promote "
                         "the checkpoint replica in one epoch, recover "
                         "bitwise at the replication watermark, resume on "
                         "the survivors)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default="soak_metrics.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ctx = build_ctx(device)
    results, failures = [], []
    for backend in args.backends.split(","):
        backend = backend.strip()
        for seed in range(args.seeds):
            _run_cell(backend, seed, f"soak_{backend}_{seed}_",
                      lambda work, b=backend, s=seed: _backend_cell(
                          ctx, b, s, work, args.shards),
                      lambda c: (f"kind={c['kind']} mirror@{c['mirror_step']} "
                                 f"rolled_back={c['rolled_back']}"),
                      results, failures)
    for seed in range(args.migrations):
        _run_cell("sharded-migrate", seed, f"soak_migrate_{seed}_",
                  lambda work, s=seed: migration_cell(ctx, s, work,
                                                      nshards=args.shards),
                  lambda c: (f"epoch={c['migrate_epoch']} "
                             f"link={c['migrate_link_bytes']}B "
                             f"mirror@{c['mirror_step']}"),
                  results, failures)
    for seed in range(args.serve):
        _run_cell("sharded-serve", seed, f"soak_serve_{seed}_",
                  lambda work, s=seed: serve_cell(ctx, s, work,
                                                  nshards=args.shards),
                  lambda c: (f"batches={c['serve_batches']} "
                             f"failovers={c['failovers']} "
                             f"hit_rate={c['hit_rate']:.2f} "
                             f"lag<={c['staleness_bound']}"),
                  results, failures)
    for seed in range(args.node_loss):
        _run_cell("sharded-node-loss", seed, f"soak_loss_{seed}_",
                  lambda work, s=seed: node_loss_cell(
                      ctx, s, work, nshards=max(args.shards, 3)),
                  lambda c: (f"dead={c['dead_shard']} "
                             f"epoch={c['promote_epoch']} "
                             f"watermark@{c['mirror_step']} "
                             f"shipped={c['ship_link_bytes']}B"),
                  results, failures)

    report = {"cells": results, "failures": failures,
              "steps_per_cell": STEPS, "points": POINTS}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"soak: {len(results)} ok, {len(failures)} failed "
          f"-> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
