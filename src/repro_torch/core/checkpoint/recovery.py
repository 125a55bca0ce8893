"""Recovery and restart from the emulated memory pool (counterpart of
``repro.core.checkpoint.recovery``; pmem, dram and remote pools).

On restart after a failure:
  1. reopen the pool (pmem: the mmap'd image survives process death;
     remote: reconnect to the memory node that outlived the trainer; dram:
     the caller passes the surviving in-process device) and read the A/B
     manifest, always a consistent snapshot;
  2. if the undo ring holds a COMMITted entry for step > manifest.mirror_step,
     the mirror apply may have been interrupted mid-write: roll the logged
     rows back (an idempotent near-memory row update);
  3. load the last committed dense snapshot blob (possibly trailing by up to
     K steps: the relaxed gap);
  4. hand back host state; ``resume_train_state`` puts it on the device of
     a fresh train state.

The pool image is the JAX package's, so a checkpoint written by either
package recovers here.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.checkpoint import store
from repro_torch.core.checkpoint.undo_log import UndoRing
from repro_torch.pool import compress as pool_compress
from repro_torch.pool.allocator import JsonRegion, PoolAllocator
from repro_torch.pool.device import (PmemPool, PoolDevice, PoolError,
                                     check_backend, check_checker_off)
from repro_torch.pool.nmp import NmpQueue
from repro_torch.tree import tree_map


@dataclass
class RecoveredState:
    embed_rows: np.ndarray          # (num_rows_flat, d) f32 mirror content
    table_name: str
    table_shape: tuple
    dense: Optional[dict]           # dense params + optimizer state (CPU tensors)
    mirror_step: int                # embedding pool consistent at this step
    dense_step: int                 # dense tier consistent at this step
    rolled_back: bool               # an interrupted apply was undone
    gap: int                        # relaxed staleness: mirror_step - dense_step
    pool: Optional[PoolDevice] = None   # reopened device (metrics, reuse)


def open_pool(root: str,
              pool: Optional[PoolDevice] = None) -> PoolDevice:
    """Reopen the checkpoint pool for `root`. A surviving in-process device
    (dram backend, or an already-open pmem handle) takes precedence. A
    remote pool is reopened over a fresh connection to the node POOL.json
    names, as the same tenant: the dead trainer's connection held nothing
    the node needs (every committed byte lives in the node's directory)."""
    if pool is not None:
        return pool
    info = store.read_json(os.path.join(root, "POOL.json"))
    backend = check_backend(info["backend"])
    if backend == "remote":
        check_checker_off()
        from repro_torch.pool.remote import RemotePool
        return RemotePool(info["addr"], tenant=info.get("tenant", "default"),
                          quota=info.get("quota", 0))
    if backend != "pmem":
        raise PoolError(
            f"pool backend {info['backend']!r} is volatile across processes; "
            "pass the surviving PoolDevice to recover(root, pool=...)")
    check_checker_off()
    return PmemPool.open(os.path.join(root, "pool.img"))


def _read_manifest(alloc: PoolAllocator) -> Optional[dict]:
    """The newest sealed manifest (the port keeps one copy, no witnesses)."""
    region = alloc.domain("manifest").get("manifest")
    return None if region is None else JsonRegion(region).read()


def recover(root: str, pool: Optional[PoolDevice] = None) -> RecoveredState:
    dev = open_pool(root, pool)
    alloc = PoolAllocator(dev)
    man = _read_manifest(alloc)
    if man is None:
        raise store.CorruptError(f"{root}: no valid manifest in pool")
    mirror = alloc.domain("embedding-mirror").get("rows")
    if mirror is None:
        raise store.CorruptError(f"{root}: no embedding mirror region")
    mirror_step = man["mirror_step"]

    # step 2: roll back committed-but-unapplied logs (newest first)
    ring = UndoRing(alloc, man.get("max_undo_logs", 64))
    nmp = NmpQueue(dev)
    rolled = False
    for step in sorted(ring.committed_steps(), reverse=True):
        if step > mirror_step:
            entry = ring.read(step)
            if entry is not None:
                idx, old_rows, _ = entry
                nmp.row_update(mirror, idx, old_rows, point="rollback")
                rolled = True

    dense = None
    dense_step = man.get("dense_step", -1)
    if dense_step >= 0:
        region = alloc.domain("dense").get(f"slot{man['dense_slot']}")
        try:
            if region is None:
                raise store.CorruptError("dense slot region missing")
            blob = bytes(dev.read(region.off, man["dense_len"], tag="dense"))
            # the frame's CRC (over the stored bytes) rejects a torn or
            # corrupt blob before decompression; only corruption downgrades
            # to dense=None
            dense, _ = store.deserialize_tree(pool_compress.unframe(blob))
        except (store.CorruptError, pool_compress.BlobCorruptError):
            dense, dense_step = None, -1

    rows = mirror.view_array()   # remote: already a local copy
    return RecoveredState(
        embed_rows=rows if getattr(dev, "remote", False) else np.array(rows),
        table_name=man["table_name"],
        table_shape=tuple(man["table_shape"]), dense=dense,
        mirror_step=mirror_step, dense_step=dense_step, rolled_back=rolled,
        gap=mirror_step - dense_step if dense_step >= 0 else -1,
        pool=dev)


def resume_train_state(rec: RecoveredState, init_state: dict) -> tuple[dict, int]:
    """Overlay recovered arrays onto a freshly initialised train state.

    Every recovered leaf becomes a new tensor on the device of the leaf it
    replaces, in that leaf's dtype (the f32 mirror of a bf16 table holds
    bf16 values, so the cast is exact). ``init_state`` is not modified,
    but where no dense snapshot was recovered the state keeps its dense
    leaves and moments, which training then updates in place.
    Returns (state, resume_step).
    """
    def like(tgt: torch.Tensor, src) -> torch.Tensor:
        return torch.as_tensor(src).to(device=tgt.device, dtype=tgt.dtype,
                                       copy=True).reshape(tgt.shape)

    state = dict(init_state)
    tgt = init_state["embed"][rec.table_name]
    state["embed"] = {rec.table_name: like(tgt, rec.embed_rows)}
    if rec.dense is not None:
        for key in ("dense", "opt_dense", "opt_embed"):
            state[key] = tree_map(like, init_state[key], rec.dense[key])
    state["step"] = torch.tensor(rec.mirror_step + 1, dtype=torch.int32,
                                 device=tgt.device)
    state["prefetch"] = None   # the relaxed carry is rebuilt by warmup
    return state, rec.mirror_step + 1
