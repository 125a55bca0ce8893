"""Fault-tolerance drills over the emulated CXL/PMEM memory pool
(counterpart of the JAX package's ``examples/fault_tolerance_demo.py``).

Four drills on smoke dlrm-rm1, selected by the pool backend:

  * ``--pool-backend remote`` (default): the paper's arrangement, the
    memory node in a process of its own. A ``python -m
    repro_torch.pool.server`` process holds a pmem image; a trainer
    subprocess checkpoints every relaxed step into it over a unix socket
    and is SIGKILLed after 12 reported steps. The node must outlive it;
    recovery reconnects to the node that POOL.json names, and the resumed
    trainer checkpoints into the same living node.
  * ``--pool-backend sharded``: several memory nodes (``--pool-shards``, 2
    by default), each a ``repro_torch.pool.server`` process on a pmem
    image. The manifest and dense snapshots are pinned to another node than
    the mirror and its undo ring. The node that owns the mirror is
    SIGKILLed after 12 reported steps and the trainer dies with it; the
    node restarts over its image, recovery reconnects every node from
    POOL.json, and the resumed trainer's fused undo capture must stay on
    the owning node (its link bytes within idx + new rows + 4 KB a step).
    Then the rebalance act: ballast pinned to the mirror's node pushes it
    past the high watermark, the policy proposes moving the mirror and its
    undo ring, the destination node is SIGKILLed in the middle of the copy
    and restarted, recovery lands on the source side of the flip with the
    partial copy swept, and the resumed policy finishes the move in one
    epoch. Then the node-loss act: the undo ring and manifest replicate
    commit by commit onto a spare node (and the mirror every 2 steps), the
    mirror's node is SIGKILLed and its image deleted for good, the replica
    is promoted in one placement epoch, recovery is bitwise at the
    replication watermark, and training resumes on the survivors.
  * ``--pool-backend pmem``: process death without a node. The trainer
    subprocess checkpoints into a pmem pool file and is SIGKILLed after 12
    reported steps; recovery reopens the pool image from disk, like a
    power-cycled PMEM module.
  * ``--pool-backend dram``: in process. A fault schedule crashes the writer
    between the undo COMMIT and the mirror apply of the 9th logged step, the
    device drops its unpersisted cache (power loss), and recovery rolls the
    interrupted apply back.

Each then replays the trainer from the same seed on a scratch dram pool up
to the recovered step and requires the recovered mirror to equal the
replay's bit for bit. During the replay, each step's undo image, captured on
the device by the fused update (``feed["old_rows"]``), is held bitwise
against the image the pool captured from its mirror. Then training resumes
for 10 steps. The demo prints ``fault-tolerance demo PASSED`` only if every
check held.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance_demo \\
        [--pool-backend remote|sharded|pmem|dram] [--pool-shards N] \\
        [--device cuda|cpu] [--work-dir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import signal
import subprocess
import sys
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import (CheckpointManager,
                                                 check_undo_images, undo_image)
from repro_torch.data.synthetic import make_batches
from repro_torch.pool import (FaultSchedule, InjectedCrash, PlacementMap,
                              PoolAllocator, PoolError, RebalancePolicy)
from repro_torch.pool.server import start_node, unix_addr
from repro_torch.training import train_loop

SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KILL_AFTER = 12        # subprocess drills: steps reported before SIGKILL
CRASH_AT = 9           # dram drill: the logged step whose apply is cut
RESUME_STEPS = 10
HEADER_BYTES = 4096    # a tier-E step's link bytes beyond idx + new rows


def setup(directory: str, backend: str, device, addr: str = "", **cc_kw):
    """The drill's trainer: smoke dlrm-rm1, batch 16, data seed 11 (a
    remote or sharded pool's tenant is "trainer"); ``cc_kw`` overrides the
    checkpoint config (a sharded pool's shards, pins and replicas)."""
    cfg = get_arch("dlrm-rm1", smoke=True).model
    cc = CheckpointConfig(directory=directory, dense_interval=3,
                          pool_backend=backend, pool_addr=addr,
                          pool_tenant="trainer")
    cc = dataclasses.replace(cc, **cc_kw)
    tc = TrainConfig(learning_rate=3e-4, embed_learning_rate=0.01,
                     checkpoint=cc)
    return cfg, tc, make_batches(cfg, 16, 0, seed=11, device=device)


def trainer(directory: str, device: str, backend: str = "pmem",
            addr: str = "", shards: str = "", placement: str = "") -> None:
    """The subprocess drills' trainer: trains and checkpoints until killed,
    printing one line per step."""
    cfg, tc, data = setup(directory, backend, device, addr,
                          pool_shards=shards, pool_placement=placement)
    state = train_loop.init_state(cfg, tc, device)
    mgr = CheckpointManager(cfg, tc.checkpoint, embed_init=state["embed"])
    train_loop.train(cfg, tc, data, 1000, relaxed=True, state=state,
                     ckpt_manager=mgr, device=device,
                     on_metrics=lambda n, m: print(
                         f"child step {n} loss {float(m['loss']):.4f}",
                         flush=True))


def crash_subprocess(directory: str, device: str, backend: str = "pmem",
                     addr: str = "", shards: str = "", placement: str = "",
                     kill=None):
    """Runs the trainer in a subprocess for ``KILL_AFTER`` reported steps,
    then SIGKILLs it, or, with ``kill``, calls ``kill()`` (which SIGKILLs a
    memory node) and waits for the trainer to die of it."""
    print(f"== launching trainer subprocess ({backend} pool) ==", flush=True)
    code = ("from repro_torch.examples.fault_tolerance_demo import trainer; "
            f"trainer({directory!r}, {device!r}, {backend!r}, {addr!r}, "
            f"{shards!r}, {placement!r})")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True)
    seen = 0
    try:
        for line in proc.stdout:
            print(" ", line.strip(), flush=True)
            seen += 1
            if seen >= KILL_AFTER:
                break
        if kill is not None and seen >= KILL_AFTER:
            kill()                   # kill -9 a memory node instead
            try:
                proc.wait(timeout=120)   # the trainer dies of the node loss
            except subprocess.TimeoutExpired:
                pass
    finally:
        proc.kill()                  # kill -9: no cleanup, no flush
        proc.wait()
        proc.stdout.close()
    if seen < KILL_AFTER:
        raise RuntimeError(f"the trainer ended after {seen} steps "
                           f"(exit {proc.returncode}) before it was killed")
    if kill is None:
        print(f"== SIGKILLed trainer after {seen} reported steps ==")
    else:
        print(f"== the trainer died after losing its memory node "
              f"(exit {proc.returncode}) ==")
    return None     # recovery reopens the pool image or reconnects the node


def crash_remote_subprocess(work: str, directory: str, device: str):
    """The memory node in a process of its own, a trainer in another that
    is SIGKILLed; the node must survive it. Returns the node's process."""
    addr = unix_addr(work)
    print(f"== starting the memory node (pool-server, pmem) at {addr} ==",
          flush=True)
    node = start_node(addr, path=os.path.join(work, "node.img"))
    try:
        crash_subprocess(directory, device, "remote", addr)
        if node.poll() is not None:
            raise RuntimeError(f"the memory node died with the trainer "
                               f"(exit {node.returncode})")
        print("== memory node still alive ==", flush=True)
    except BaseException:
        stop_node(node)
        raise
    return node


def stop_node(node) -> None:
    node.terminate()
    try:
        node.wait(timeout=30)
    except subprocess.TimeoutExpired:
        node.kill()
        node.wait()
    node.stdout.close()


class Nodes:
    """Memory-node processes (``python -m repro_torch.pool.server``), node
    i on the pmem image ``<work>/node<i>.img`` at ``addrs[i]``."""

    def __init__(self, work: str, addrs: list):
        self.work = work
        self.addrs = addrs
        self.procs = [None] * len(addrs)

    def image(self, i: int) -> str:
        return os.path.join(self.work, f"node{i}.img")

    def start(self, i: int):
        self.procs[i] = start_node(self.addrs[i], path=self.image(i))

    def kill(self, i: int):
        """kill -9 of node i: its unpersisted cache dies with it."""
        proc, self.procs[i] = self.procs[i], None
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
        proc.stdout.close()

    def check_alive(self, skip=()):
        for i, proc in enumerate(self.procs):
            if i not in skip and (proc is None or proc.poll() is not None):
                raise RuntimeError(f"memory node {i} is not alive")

    def stop(self):
        for i, proc in enumerate(self.procs):
            if proc is not None:
                stop_node(proc)
                self.procs[i] = None


def crash_sharded_subprocess(work: str, directory: str, device: str,
                             shards_arg: str) -> Nodes:
    """The multi-node drill: memory nodes in processes of their own, the
    domains spread over them, the node owning the mirror SIGKILLed under a
    running trainer, then restarted over its pmem image. Returns the
    nodes, all up."""
    if shards_arg.strip().isdigit():
        addrs = [unix_addr(work, f"node{i}.sock")
                 for i in range(int(shards_arg))]
    else:
        addrs = [a.strip() for a in shards_arg.split(",") if a.strip()]
    if len(addrs) < 2:
        raise RuntimeError("the sharded drill needs 2 memory nodes or more")
    nodes = Nodes(work, addrs)
    print(f"== starting {len(addrs)} memory nodes (pool-servers, pmem) ==",
          flush=True)
    try:
        for i in range(len(addrs)):
            nodes.start(i)
        hot = PlacementMap(shards=tuple(addrs)).place("embedding-mirror")
        cold = (hot + 1) % len(addrs)
        print(f"== mirror + undo ring on node {hot}; manifest + dense pinned "
              f"to node {cold} ==", flush=True)

        def kill_hot():
            nodes.kill(hot)
            print(f"== kill -9'd memory node {hot} ({addrs[hot]}) ==",
                  flush=True)
        crash_subprocess(directory, device, "sharded", shards=",".join(addrs),
                         placement=f"manifest={cold},dense={cold}",
                         kill=kill_hot)
        nodes.check_alive(skip=(hot,))
        print("== the surviving memory nodes are alive ==")
        nodes.start(hot)
        print(f"== memory node {hot} restarted over its pmem image ==")
    except BaseException:
        nodes.stop()
        raise
    return nodes


def crash_dram_inprocess(directory: str, device):
    print("== in-process crash drill (dram pool, injected fault) ==")
    cfg, tc, data = setup(directory, "dram", device)
    state = train_loop.init_state(cfg, tc, device)
    mgr = CheckpointManager(cfg, tc.checkpoint, embed_init=state["embed"],
                            faults=FaultSchedule.crash_at(
                                "tier_e.between-commit-and-apply",
                                occurrence=CRASH_AT))
    try:
        train_loop.train(cfg, tc, data, 1000, relaxed=True, state=state,
                         ckpt_manager=mgr, device=device,
                         on_metrics=lambda n, m: print(
                             f"  step {n} loss {float(m['loss']):.4f}"))
    except InjectedCrash as e:
        print(f"== {e} ==")
    else:
        raise RuntimeError("the injected fault never fired")
    mgr.pool.crash()     # power loss: the unpersisted cache is gone
    return mgr.pool


def replay(directory: str, device, steps: int):
    """The trainer from the same seed on a scratch dram pool for ``steps``
    steps. Returns its mirror and the count of logged steps whose undo
    image, captured on the device, equals the pool's bitwise."""
    cfg, tc, data = setup(directory, "dram", device)
    state = train_loop.init_state(cfg, tc, device)
    mgr = CheckpointManager(cfg, tc.checkpoint, embed_init=state["embed"])
    images = {}

    def keep_image(n, m):       # to the host at once: the next step reuses it
        images[n] = undo_image(m["ckpt_feed"])
    try:
        train_loop.train(cfg, tc, data, steps, relaxed=True, state=state,
                         ckpt_manager=mgr, device=device, on_metrics=keep_image)
        checked = check_undo_images(mgr.ring, images)
        return np.array(mgr.mirror_rows), checked
    finally:
        mgr.close()


def bitwise_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def run_recovery(work: str, backend: str, device, surviving_pool,
                 nodes: "Nodes | None" = None, high: float = 0.75) -> None:
    drill = os.path.join(work, "drill")
    rec = recovery.recover(drill, pool=surviving_pool)
    print(f"== recovered: embeddings@{rec.mirror_step} dense@{rec.dense_step} "
          f"gap={rec.gap} rolled_back={rec.rolled_back} ==")
    sharded = backend == "sharded"
    try:
        if rec.mirror_step < 0:
            raise RuntimeError("nothing was recovered")
        want, checked = replay(os.path.join(work, "replay"), device,
                               rec.mirror_step + 1)
        if checked != rec.mirror_step + 1:
            raise RuntimeError(f"undo images of {checked} steps checked, want "
                               f"{rec.mirror_step + 1}")
        print(f"== undo images of {checked} logged steps: the device's equal "
              "the pool's bitwise ==")
        if not bitwise_equal(rec.embed_rows, want):
            raise RuntimeError("the recovered mirror differs from a clean replay")
        print(f"== recovered mirror is BIT-IDENTICAL to a clean replay "
              f"through step {rec.mirror_step} ==")

        # sharded: tier-E only, so that the resumed steps' link bytes are
        # the fused capture's alone
        cfg, tc, data = setup(drill, backend, device, **(dict(
            pool_shards=",".join(rec.pool.placement.shards), dense_interval=0)
            if sharded else {}))
        state, resume = recovery.resume_train_state(
            rec, train_loop.init_state(cfg, tc, device))
        mgr = CheckpointManager(cfg, tc.checkpoint, pool=rec.pool)
        mgr.init_mirror(state["embed"], step=rec.mirror_step)
        if sharded:
            rec.pool.reset_metrics()      # the resumed tier-E steps only
        state, losses = train_loop.train(cfg, tc, data, RESUME_STEPS,
                                         relaxed=True, state=state,
                                         start_step=resume, ckpt_manager=mgr,
                                         device=device)
        if not np.isfinite(losses).all():
            raise RuntimeError(f"non-finite resumed losses {losses}")
        table = state["embed"]["emb_tables"].float().cpu().numpy()
        if not bitwise_equal(np.asarray(mgr.mirror_rows),
                             table.reshape(-1, table.shape[-1])):
            raise RuntimeError("after the resume the mirror differs from the tables")
        print(f"== resumed at step {resume}, {RESUME_STEPS} more steps, final "
              f"loss {losses[-1]:.4f}; the mirror equals the tables ==")
        if sharded:
            check_link_bound(mgr, mgr.stats["bytes_e"], RESUME_STEPS,
                             "the owning shard")
            for i, snap in enumerate(mgr.pool.shard_metrics()):
                print(f"  shard {i}: link={snap['link_bytes']}B "
                      f"media={snap['media_bytes']}B crashes={snap['crashes']}")
        print(mgr.pool.metrics.report())
        if sharded:
            rebalance_act(work, device, nodes, state, resume + RESUME_STEPS,
                          mgr, high)
            node_loss_act(work, device, nodes)
        else:
            mgr.close()
    finally:
        rec.pool.close()


def check_link_bound(mgr, sent: int, steps: int, where: str):
    """The fused undo capture ran on the node that owns the mirror: the
    link carried no more than the steps' idx and new rows and a header
    allowance per step."""
    link = mgr.pool.metrics.link_bytes()
    if link > sent + steps * HEADER_BYTES:
        raise RuntimeError(f"the fused capture left {where}: {link}B on the "
                           f"link > {sent}B of operands + headers")
    print(f"== fused undo capture stayed on {where}: {link}B link <= {sent}B "
          f"operands + O(header) ==")


def rebalance_act(work: str, device, nodes: Nodes, state, start: int, mgr,
                  high: float):
    """Live migration on the resumed trainer: ballast pinned to the mirror's
    node (a pin is operator intent, never auto-migrated) pushes it past the
    high watermark; the policy proposes moving the mirror and its undo
    ring; the destination node is SIGKILLed in the middle of the copy and
    restarted; recovery lands on the source side of the flip, the partial
    copy swept; the resumed policy then moves the mirror group in ONE
    epoch, and the fused capture stays on its new node."""
    drill = os.path.join(work, "drill")
    pool = mgr.pool
    addrs = list(pool.placement.shards)
    hot = pool.placement.place("embedding-mirror")
    print(f"== REBALANCE ACT: overfill node {hot} (the mirror's) past the "
          f"{high:.2f} watermark ==")
    pool.placement = pool.placement.with_pin("ballast", hot)
    mgr.record_placement()
    snap = pool.shard_metrics()[hot]
    need = int(high * snap["capacity_bytes"] - snap["used_bytes"]) + (64 << 10)
    headroom = snap["capacity_bytes"] - snap["used_bytes"] - (256 << 10)
    ballast = max(min(need, headroom), 0)
    if ballast > 0:
        PoolAllocator(pool).domain("ballast").alloc("fill", shape=(ballast,),
                                                    dtype="uint8")
    for i, g in enumerate(pool.shard_metrics()):
        print(f"  gauge node {i}: used={g['used_bytes']}B "
              f"cap={g['capacity_bytes']}B "
              f"fill={g['used_bytes'] / g['capacity_bytes']:.2f}")
    pool.rebalance = RebalancePolicy(high=high, check_every=2)
    proposals = pool.rebalance.propose(pool)
    if not proposals:
        raise RuntimeError(f"the watermark never tripped: the ballast could "
                           f"not push node {hot} to {high:.2f}")
    mig = proposals[0]
    if mig.domain != "embedding-mirror" \
            or set(mig.group) != {"embedding-mirror", "undo-log"}:
        raise RuntimeError(f"unexpected proposal {mig}")
    dst = mig.dst
    print(f"== the policy proposes: {mig.reason} ==")
    hits = {"mid": 0}

    def kill_dst(point):
        # the second mid-copy window: one region has landed on the
        # destination, the partial copy the open-time sweep must reclaim
        if point == "migrate.mid-copy":
            hits["mid"] += 1
            if hits["mid"] == 2:
                nodes.kill(dst)
                print(f"== kill -9'd the DESTINATION memory node {dst} "
                      "mid-copy ==")

    pool.migrate_window_hook = kill_dst
    cfg, tc, data = setup(drill, "sharded", device, pool_shards=",".join(addrs),
                          dense_interval=0)
    try:
        train_loop.train(cfg, tc, data, 20, relaxed=True, state=state,
                         start_step=start, ckpt_manager=mgr, device=device)
        mgr.flush()
        surfaced = False
    except (RuntimeError, PoolError) as e:
        surfaced = True
        print(f"== the trainer lost the migration destination mid-copy "
              f"({type(e).__name__}) ==")
    if not surfaced:
        raise RuntimeError("the destination's kill never surfaced")
    # every tier-E through the last manifest advance persisted on the
    # source node: recovery must give exactly these rows
    oracle = np.array(mgr.mirror_rows)
    pool.close()
    nodes.start(dst)
    print(f"== memory node {dst} restarted over its pmem image ==")
    rec = recovery.recover(drill)       # replays the epochs, sweeps
    try:
        if rec.pool.placement.place("embedding-mirror") != hot:
            raise RuntimeError("a crash before the flip must leave the mirror "
                               "on its source")
        if "embedding-mirror" in rec.pool.shard_domains(dst):
            raise RuntimeError("the partial copy survived the open-time sweep")
        if not bitwise_equal(rec.embed_rows, oracle):
            raise RuntimeError("the recovered mirror differs from the source's")
        print(f"== recovered on the SOURCE side of the flip, bit-identical "
              f"through step {rec.mirror_step}; the partial copy swept ==")
        state, resume = recovery.resume_train_state(
            rec, train_loop.init_state(cfg, tc, device))
        rec.pool.rebalance = RebalancePolicy(high=high, check_every=2)
        mgr2 = CheckpointManager(cfg, tc.checkpoint, pool=rec.pool)
        mgr2.init_mirror(state["embed"], step=rec.mirror_step)
        state, _ = train_loop.train(cfg, tc, data, 6, relaxed=True, state=state,
                                    start_step=resume, ckpt_manager=mgr2,
                                    device=device)
        mgr2.flush()
        pm = mgr2.pool.placement
        new_home, last = pm.place("embedding-mirror"), pm.epochs[-1]
        if mgr2.stats["migrations"] < 1 or new_home != dst:
            raise RuntimeError(f"the watermark never moved the mirror "
                               f"(home {new_home}, stats {mgr2.stats})")
        if pm.place("undo-log") != new_home \
                or not {"embedding-mirror", "undo-log"} <= set(last.moves):
            raise RuntimeError("the mirror and its undo ring must move in "
                               "the SAME epoch")
        print(f"== the policy migrated embedding-mirror + undo-log to node "
              f"{new_home} in epoch {last.epoch} "
              f"({mgr2.stats['migration_link_bytes']}B over the link) ==")
        mgr2.pool.rebalance = None
        mgr2.pool.reset_metrics()
        sent0 = mgr2.stats["bytes_e"]
        train_loop.train(cfg, tc, data, 5, relaxed=True, state=state,
                         start_step=resume + 6, ckpt_manager=mgr2,
                         device=device)
        mgr2.flush()
        check_link_bound(mgr2, mgr2.stats["bytes_e"] - sent0, 5,
                         "the NEW owning node")
        mirror_final = np.array(mgr2.mirror_rows)
    finally:
        rec.pool.close()
    rec2 = recovery.recover(drill)
    try:
        if rec2.pool.placement.place("embedding-mirror") != new_home \
                or not bitwise_equal(rec2.embed_rows, mirror_final):
            raise RuntimeError("the recovery after the migration differs")
        print(f"== post-migration recovery BIT-IDENTICAL through step "
              f"{rec2.mirror_step}, the mirror on node {new_home} ==")
    finally:
        rec2.pool.close()


def node_loss_act(work: str, device, nodes: Nodes):
    """Permanent loss: the checkpoint domains replicate onto a spare node
    (the undo ring and manifest every commit, the mirror every 2 steps);
    the mirror's node is SIGKILLed and its image deleted, never to come
    back; the replica is promoted in ONE placement epoch; recovery is
    bitwise at the replication watermark; training goes on with the
    survivors alone."""
    drill = os.path.join(work, "drill")
    rec = recovery.recover(drill)
    pool = rec.pool
    addrs = list(pool.placement.shards)
    n = len(addrs)
    home = pool.placement.place("embedding-mirror")
    spare = (home + 1) % n
    print(f"== NODE-LOSS ACT: mirror + undo ring on node {home}; checkpoint "
          f"replica on node {spare} ==")
    try:
        # only the mirror group may live on the doomed node
        pool.epoch_sink = lambda pm: recovery.record_placement(drill, pool)
        for dom in ("manifest", "dense"):
            if pool.placement.place(dom) == home:
                pool.migrate_domain(dom, spare)
                print(f"== drained {dom} off node {home} onto node {spare} ==")
        cfg, tc, data = setup(drill, "sharded", device,
                              pool_shards=",".join(addrs), dense_interval=0,
                              pool_replica=spare, pool_replica_every=2,
                              pool_ckpt_replica=spare,
                              pool_manifest_quorum=n >= 3)
        state, resume = recovery.resume_train_state(
            rec, train_loop.init_state(cfg, tc, device))
        mgr = CheckpointManager(cfg, tc.checkpoint, pool=pool)
        mgr.init_mirror(state["embed"], step=rec.mirror_step)
        mirrors = {}
        for k in range(8):
            state, _ = train_loop.train(cfg, tc, data, 1, relaxed=True,
                                        state=state, start_step=resume + k,
                                        ckpt_manager=mgr, device=device)
            mgr.flush()
            mirrors[resume + k] = np.array(mgr.mirror_rows)
        last = resume + 7
        if mgr.stats["replica_refresh_failures"]:
            raise RuntimeError(f"replication degraded: {mgr.stats}")
        print(f"== replication on: {mgr.stats['ship_steps']} commit-coupled "
              f"ships ({mgr.stats['ship_link_bytes']}B of slots + manifest), "
              f"{mgr.stats['replica_refreshes']} mirror refreshes "
              f"({mgr.stats['replica_link_bytes']}B) ==")
        nodes.kill(home)
        os.remove(nodes.image(home))
        print(f"== kill -9'd memory node {home} ({addrs[home]}) and DELETED "
              "its image: this node never comes back ==")
        try:
            train_loop.train(cfg, tc, data, 10, relaxed=True, state=state,
                             start_step=last + 1, ckpt_manager=mgr,
                             device=device)
            mgr.flush()
            surfaced = False
        except (RuntimeError, PoolError) as e:
            surfaced = True
            print(f"== the trainer died of the node loss ({type(e).__name__}) ==")
        if not surfaced:
            raise RuntimeError("the node loss never surfaced")
    finally:
        pool.close()

    pool2 = recovery.open_pool(drill)     # the survivors only
    try:
        if pool2.dead_shards() != [home]:
            raise RuntimeError(f"dead shards {pool2.dead_shards()}, want [{home}]")
        epoch0 = pool2.placement.epoch
        pool2.epoch_sink = lambda pm: recovery.record_placement(drill, pool2)
        info = pool2.promote_replica("embedding-mirror")
        if set(info["promoted"]) != {"embedding-mirror", "undo-log"} \
                or info["epoch"] != epoch0 + 1:
            raise RuntimeError(f"the promotion must be ONE epoch flip: {info}")
        print(f"== promoted {'+'.join(info['promoted'])} to node {spare} in "
              f"ONE epoch ({info['epoch']}); {info['link_bytes']}B copied on "
              "that node, no wire to the dead one ==")
    finally:
        pool2.close()

    rec2 = recovery.recover(drill)
    try:
        wm = rec2.mirror_step
        if wm not in mirrors or not bitwise_equal(rec2.embed_rows, mirrors[wm]):
            raise RuntimeError(f"the promoted mirror at step {wm} differs")
        print(f"== recovered BIT-IDENTICAL through the replication watermark "
              f"(step {wm}, manifest at {last}, rolled_back="
              f"{rec2.rolled_back}) ==")
        cfg, tc, data = setup(drill, "sharded", device,
                              pool_shards=",".join(addrs), dense_interval=0)
        state, resume = recovery.resume_train_state(
            rec2, train_loop.init_state(cfg, tc, device))
        mgr2 = CheckpointManager(cfg, tc.checkpoint, pool=rec2.pool)
        mgr2.init_mirror(state["embed"], step=rec2.mirror_step)
        _, losses = train_loop.train(cfg, tc, data, 6, relaxed=True,
                                     state=state, start_step=resume,
                                     ckpt_manager=mgr2, device=device)
        mgr2.flush()
        if not np.isfinite(losses).all():
            raise RuntimeError(f"non-finite losses {losses}")
        print(f"== resumed on the survivors at step {resume}, 6 more steps, "
              f"final loss {losses[-1]:.4f} ==")
        mirror_final = np.array(mgr2.mirror_rows)
    finally:
        rec2.pool.close()
    rec3 = recovery.recover(drill)        # the dead node stays dead
    try:
        if not bitwise_equal(rec3.embed_rows, mirror_final):
            raise RuntimeError("the recovery after the promotion differs")
        print(f"== post-promotion recovery bit-identical through step "
              f"{rec3.mirror_step}; node {home} still absent ==")
        for i, snap in enumerate(rec3.pool.shard_metrics()):
            print(f"  node {i}: " + ("UNREACHABLE" if snap.get("unreachable")
                                     else f"used={snap['used_bytes']}B "
                                          f"link={snap['link_bytes']}B"))
    finally:
        rec3.pool.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool-backend", default="remote",
                    choices=["remote", "sharded", "pmem", "dram"])
    ap.add_argument("--pool-shards", default="2",
                    help="sharded drill: a node count, or a comma list of "
                         "unix: addresses to bind the memory nodes at")
    ap.add_argument("--rebalance-high", type=float, default=0.75,
                    help="sharded drill: high watermark of the rebalance "
                         "act (used/capacity fraction)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    ap.add_argument("--work-dir", default=None,
                    help="where the drill's pool files go (a temporary "
                         "directory inside it, removed at the end)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    work = tempfile.mkdtemp(prefix="ft-demo-", dir=args.work_dir)
    node, nodes = None, None
    try:
        drill = os.path.join(work, "drill")
        surviving = None     # recovery reopens the image or reconnects
        if args.pool_backend == "remote":
            node = crash_remote_subprocess(work, drill, str(device))
        elif args.pool_backend == "sharded":
            nodes = crash_sharded_subprocess(work, drill, str(device),
                                             args.pool_shards)
        elif args.pool_backend == "pmem":
            surviving = crash_subprocess(drill, str(device))
        else:
            surviving = crash_dram_inprocess(drill, device)
        run_recovery(work, args.pool_backend, device, surviving, nodes,
                     args.rebalance_high)
        if node is not None and node.poll() is not None:
            raise RuntimeError(f"the memory node exited during the drill "
                               f"(exit {node.returncode})")
    finally:
        if node is not None:
            stop_node(node)
            print("== memory node shut down ==")
        if nodes is not None:
            nodes.stop()
            print("== memory nodes shut down ==")
        shutil.rmtree(work, ignore_errors=True)
    print("fault-tolerance demo PASSED")


if __name__ == "__main__":
    main()
