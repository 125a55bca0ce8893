"""Shared memory node: two trainers, one pool, per-tenant accounting
(counterpart of the JAX package's ``examples/shared_pool_demo.py``).

Starts a memory node (``python -m repro_torch.pool.server``, pmem-backed),
then runs TWO trainer processes against it at once as different tenants
("trainer-a", "trainer-b"), each with a byte quota, each training smoke
dlrm-rm1 with every relaxed step checkpointed into its own namespace. When
both finish, the parent connects as an operator and prints the per-tenant
traffic and energy the node attributed to each trainer, then checks the
isolation properties:

  * a third tenant ("eve") cannot read either trainer's bytes: raw-offset
    access outside its owned regions raises ``TenantIsolationError``;
  * allocating past a tenant's byte quota raises ``QuotaExceededError``.

It prints ``shared-pool demo PASSED`` only if every check held.

    PYTHONPATH=src python -m repro_torch.examples.shared_pool_demo \\
        [--device cuda|cpu] [--work-dir DIR]
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

from repro_torch import resolve_device

SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
QUOTA = 64 << 20
STEPS = 8


def tenant_trainer(directory: str, addr: str, tenant: str, seed: int,
                   device: str) -> None:
    """One tenant's trainer process: smoke dlrm-rm1, batch 16, params and
    data from ``seed``, every relaxed step checkpointed into the node."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import CheckpointConfig, TrainConfig
    from repro_torch.core.checkpoint.manager import CheckpointManager
    from repro_torch.data.synthetic import make_batches
    from repro_torch.training import train_loop

    cfg = get_arch("dlrm-rm1", smoke=True).model
    # max_undo_logs trimmed so that the undo ring fits the tenant's quota
    # (the default 64-slot ring alone would exceed 64 MiB for this model)
    cc = CheckpointConfig(directory=directory, dense_interval=4,
                          pool_backend="remote", pool_addr=addr,
                          pool_tenant=tenant, pool_quota=QUOTA,
                          max_undo_logs=8)
    tc = TrainConfig(learning_rate=3e-4, embed_learning_rate=0.01,
                     checkpoint=cc, seed=seed)
    data = make_batches(cfg, 16, 0, seed=seed, device=device)
    state = train_loop.init_state(cfg, tc, device)
    mgr = CheckpointManager(cfg, cc, embed_init=state["embed"])
    train_loop.train(cfg, tc, data, STEPS, relaxed=True, state=state,
                     ckpt_manager=mgr, device=device)
    print(f"[{tenant}] done: {mgr.stats}", flush=True)
    mgr.close()


def drill(work: str, device: str) -> None:
    from repro_torch.pool import (PoolMetrics, QuotaExceededError, RemotePool,
                                  TenantIsolationError)
    from repro_torch.pool.allocator import DATA_START, PoolAllocator
    from repro_torch.pool.server import start_node, unix_addr

    addr = unix_addr(work)
    print(f"== starting memory node at {addr} ==", flush=True)
    node = start_node(addr, path=os.path.join(work, "pool.img"))
    try:
        print("== launching two trainer tenants at once ==", flush=True)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        trainers = []
        for i, tenant in enumerate(("trainer-a", "trainer-b")):
            code = ("from repro_torch.examples.shared_pool_demo import "
                    f"tenant_trainer; tenant_trainer("
                    f"{os.path.join(work, tenant)!r}, {addr!r}, {tenant!r}, "
                    f"{i}, {device!r})")
            trainers.append((tenant, subprocess.Popen(
                [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                text=True)))
        failed = []
        for tenant, proc in trainers:
            out, _ = proc.communicate()
            print(out.strip(), flush=True)
            if proc.returncode != 0:
                failed.append(f"{tenant} (exit {proc.returncode})")
        if failed:
            raise RuntimeError(f"trainer tenants failed: {failed}")

        print("== per-tenant accounting (as attributed by the memory node) ==")
        op = RemotePool(addr, tenant="operator", timeout=60.0)
        snaps = op.metrics_snapshot(scope="all")
        for name in ("trainer-a", "trainer-b"):
            if name not in snaps:
                raise RuntimeError(f"the node has no counters of {name}")
        for name, snap in sorted(snaps.items()):
            m = PoolMetrics.from_snapshot(snap)
            print(f"-- tenant {name!r}: media={m.media_bytes()}B "
                  f"link={m.link_bytes()}B "
                  f"energy={m.energy()['total']:.6f}J")
            if name.startswith("trainer-") and not (
                    m.media_bytes() > 0 and m.link_bytes() > 0):
                raise RuntimeError(f"tenant {name}: no traffic attributed")
        op.close()

        print("== isolation drill ==")
        eve = RemotePool(addr, tenant="eve", quota=1 << 16, timeout=60.0)
        try:
            eve.read(DATA_START, 64)
            raise RuntimeError("eve read another tenant's bytes")
        except TenantIsolationError as e:
            print(f"  cross-tenant read denied: {e}")
        try:
            PoolAllocator(eve).domain("grab").alloc("big", shape=(1 << 20,),
                                                    dtype="uint8")
            raise RuntimeError("eve allocated past her quota")
        except QuotaExceededError as e:
            print(f"  over-quota alloc denied: {e}")
        eve.close()
        if node.poll() is not None:
            raise RuntimeError(f"the memory node exited (exit "
                               f"{node.returncode})")
    finally:
        node.terminate()
        node.wait()
        node.stdout.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    ap.add_argument("--work-dir", default=None,
                    help="where the node's image and the trainers' files go "
                         "(a temporary directory inside it, removed at the "
                         "end)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    work = tempfile.mkdtemp(prefix="shared-pool-", dir=args.work_dir)
    try:
        drill(work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("shared-pool demo PASSED")


if __name__ == "__main__":
    main()
