"""Fault-tolerance drills over the emulated CXL/PMEM memory pool
(counterpart of the JAX package's ``examples/fault_tolerance_demo.py``).

Three drills on smoke dlrm-rm1, selected by the pool backend:

  * ``--pool-backend remote`` (default): the paper's arrangement, the
    memory node in a process of its own. A ``python -m
    repro_torch.pool.server`` process holds a pmem image; a trainer
    subprocess checkpoints every relaxed step into it over a unix socket
    and is SIGKILLed after 12 reported steps. The node must outlive it;
    recovery reconnects to the node that POOL.json names, and the resumed
    trainer checkpoints into the same living node.
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
check held. The JAX demo's sharded drill (several memory nodes) is not
ported and raises.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance_demo \\
        [--pool-backend remote|pmem|dram] [--device cuda|cpu] [--work-dir DIR]
"""
from __future__ import annotations

import argparse
import os
import shutil
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
from repro_torch.pool import FaultSchedule, InjectedCrash
from repro_torch.pool.device import NOT_PORTED
from repro_torch.pool.server import start_node, unix_addr
from repro_torch.training import train_loop

SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KILL_AFTER = 12        # subprocess drills: steps reported before SIGKILL
CRASH_AT = 9           # dram drill: the logged step whose apply is cut
RESUME_STEPS = 10


def setup(directory: str, backend: str, device, addr: str = ""):
    """The drill's trainer: smoke dlrm-rm1, batch 16, data seed 11 (a
    remote pool's tenant is "trainer")."""
    cfg = get_arch("dlrm-rm1", smoke=True).model
    cc = CheckpointConfig(directory=directory, dense_interval=3,
                          pool_backend=backend, pool_addr=addr,
                          pool_tenant="trainer")
    tc = TrainConfig(learning_rate=3e-4, embed_learning_rate=0.01,
                     checkpoint=cc)
    return cfg, tc, make_batches(cfg, 16, 0, seed=11, device=device)


def trainer(directory: str, device: str, backend: str = "pmem",
            addr: str = "") -> None:
    """The subprocess drills' trainer: trains and checkpoints until killed,
    printing one line per step."""
    cfg, tc, data = setup(directory, backend, device, addr)
    state = train_loop.init_state(cfg, tc, device)
    mgr = CheckpointManager(cfg, tc.checkpoint, embed_init=state["embed"])
    train_loop.train(cfg, tc, data, 1000, relaxed=True, state=state,
                     ckpt_manager=mgr, device=device,
                     on_metrics=lambda n, m: print(
                         f"child step {n} loss {float(m['loss']):.4f}",
                         flush=True))


def crash_subprocess(directory: str, device: str, backend: str = "pmem",
                     addr: str = ""):
    print(f"== launching trainer subprocess ({backend} pool) ==", flush=True)
    code = ("from repro_torch.examples.fault_tolerance_demo import trainer; "
            f"trainer({directory!r}, {device!r}, {backend!r}, {addr!r})")
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
    finally:
        proc.kill()                  # kill -9: no cleanup, no flush
        proc.wait()
        proc.stdout.close()
    if seen < KILL_AFTER:
        raise RuntimeError(f"the trainer ended after {seen} steps "
                           f"(exit {proc.returncode}) before it was killed")
    print(f"== SIGKILLed trainer after {seen} reported steps ==")
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


def run_recovery(work: str, backend: str, device, surviving_pool) -> None:
    drill = os.path.join(work, "drill")
    rec = recovery.recover(drill, pool=surviving_pool)
    print(f"== recovered: embeddings@{rec.mirror_step} dense@{rec.dense_step} "
          f"gap={rec.gap} rolled_back={rec.rolled_back} ==")
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

        cfg, tc, data = setup(drill, backend, device)
        state, resume = recovery.resume_train_state(
            rec, train_loop.init_state(cfg, tc, device))
        mgr = CheckpointManager(cfg, tc.checkpoint, pool=rec.pool)
        mgr.init_mirror(state["embed"], step=rec.mirror_step)
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
        print(mgr.pool.metrics.report())
        mgr.close()
    finally:
        rec.pool.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool-backend", default="remote",
                    choices=["remote", "pmem", "dram", *NOT_PORTED])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    ap.add_argument("--work-dir", default=None,
                    help="where the drill's pool files go (a temporary "
                         "directory inside it, removed at the end)")
    args = ap.parse_args(argv)
    if args.pool_backend in NOT_PORTED:
        raise NotImplementedError(
            f"--pool-backend {args.pool_backend}: the sharded pool (several "
            "memory nodes) is not ported yet (ROADMAP queue 1 item 6)")
    device = resolve_device(args.device)
    work = tempfile.mkdtemp(prefix="ft-demo-", dir=args.work_dir)
    node = None
    try:
        drill = os.path.join(work, "drill")
        if args.pool_backend == "remote":
            node = crash_remote_subprocess(work, drill, str(device))
            surviving = None     # recovery reconnects to the node
        elif args.pool_backend == "pmem":
            surviving = crash_subprocess(drill, str(device))
        else:
            surviving = crash_dram_inprocess(drill, device)
        run_recovery(work, args.pool_backend, device, surviving)
        if node is not None and node.poll() is not None:
            raise RuntimeError(f"the memory node exited during the drill "
                               f"(exit {node.returncode})")
    finally:
        if node is not None:
            stop_node(node)
            print("== memory node shut down ==")
        shutil.rmtree(work, ignore_errors=True)
    print("fault-tolerance demo PASSED")


if __name__ == "__main__":
    main()
