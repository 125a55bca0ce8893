"""Recovery and restart from the emulated memory pool (counterpart of
``repro.core.checkpoint.recovery``).

On restart after a failure:
  1. reopen the pool (pmem: the mmap'd image survives process death;
     remote: reconnect to the memory node that outlived the trainer;
     sharded: reconnect every node of POOL.json's placement, replaying its
     epochs, a lost node kept as typed errors; dram: the caller passes the
     surviving in-process device) and read the A/B manifest, always a
     consistent snapshot (with quorum witnesses, the 2-of-3 majority). A
     mirror promoted from a read replica is consistent at the replica's
     watermark W: the undo ring shipped with it rolls back every committed
     step after W;
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
                                     check_backend, maybe_check)
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
    the node needs (every committed byte lives in the node's directory). A
    sharded pool reconnects every node of the recorded placement in order
    and replays its epoch records, so every domain is found where it last
    lived (never placed again, never hashed again); a node that no longer
    answers keeps its index and raises ``PoolConnectionError`` for every op
    that reaches it, and the open-time sweep reclaims any copy a crashed
    migration stranded on the wrong side of its flip. A device it opens is
    wrapped in the crash-consistency checker when ``REPRO_POOL_CHECK``
    asks for it, so a checked run stays checked across the power cycle."""
    if pool is not None:
        return pool
    info = store.read_json(os.path.join(root, "POOL.json"))
    backend = check_backend(info["backend"])
    if backend == "remote":
        from repro_torch.pool.remote import RemotePool
        return maybe_check(
            RemotePool(info["addr"], tenant=info.get("tenant", "default"),
                       quota=info.get("quota", 0)))
    if backend == "sharded":
        from repro_torch.pool.placement import PlacementMap
        from repro_torch.pool.sharded import ShardedPool
        pmap = PlacementMap.from_json({"shards": info.get("shards"),
                                       "pin": info.get("placement"),
                                       "epochs": info.get("epochs")})
        dev = ShardedPool(list(pmap.shards),
                          tenant=info.get("tenant", "default"),
                          quota=info.get("quota", 0), placement=pmap,
                          allow_unreachable=True)
        dead = dev.dead_shards()
        if dead:
            print(f"[recovery] shard(s) {dead} permanently unreachable: "
                  "continuing with the survivors")
        swept = dev.sweep_stale_domains()
        if swept:
            print("[recovery] swept stale migration copies: "
                  + ", ".join(f"{d}@shard{i}" for d, i in swept))
        return maybe_check(dev)
    if backend != "pmem":
        raise PoolError(
            f"pool backend {info['backend']!r} is volatile across processes; "
            "pass the surviving PoolDevice to recover(root, pool=...)")
    return maybe_check(PmemPool.open(os.path.join(root, "pool.img")))


def record_placement(root: str, pool) -> None:
    """Publish ``pool``'s placement into POOL.json (the manager's epoch
    sink, for recovery-side flips too): set it as ``pool.epoch_sink``
    before ``promote_replica`` so that the promotion's epoch is durable at
    its flip."""
    path = os.path.join(root, "POOL.json")
    try:
        info = store.read_json(path)
    except (OSError, ValueError):
        info = {"backend": "sharded"}
    pj = pool.placement.to_json()
    info.update(shards=pj["shards"], placement=pj["pin"],
                epochs=pj["epochs"])
    store.write_json_atomic(path, info)


def _read_manifest(alloc: PoolAllocator, dev) -> Optional[dict]:
    """The manifest election over the primary and any pinned quorum
    witnesses (``manifest@w*``): of every copy that can be reached, the
    highest sealed sequence number that at least two copies agree on (the
    2-of-3 majority), else the single highest (no quorum configured, or
    one copy left). A copy on a lost shard is absent from the vote."""
    doms = ["manifest"]
    pmap = getattr(dev, "placement", None)
    if pmap is not None:
        doms += sorted(d for d in pmap.pin if d.startswith("manifest@w"))
    copies: list[tuple[int, dict]] = []
    for dom in doms:
        try:
            region = alloc.domain(dom).get("manifest")
            if region is None:
                continue
            jr = JsonRegion(region)
            man = jr.read()
            if man is not None:
                copies.append((jr.read_seq(), man))
        except PoolError:
            continue
    if not copies:
        return None
    counts: dict[int, int] = {}
    for seq, _ in copies:
        counts[seq] = counts.get(seq, 0) + 1
    quorum = [seq for seq, n in counts.items() if n >= 2]
    if quorum:
        best = max(quorum)
        return next(man for seq, man in copies if seq == best)
    return max(copies, key=lambda c: c[0])[1]


def recover(root: str, pool: Optional[PoolDevice] = None) -> RecoveredState:
    dev = open_pool(root, pool)
    alloc = PoolAllocator(dev)
    man = _read_manifest(alloc, dev)
    if man is None:
        raise store.CorruptError(f"{root}: no valid manifest in pool")
    mirror_dom = alloc.domain("embedding-mirror")
    mirror = mirror_dom.get("rows")
    if mirror is None:
        raise store.CorruptError(f"{root}: no embedding mirror region")
    mirror_step = man["mirror_step"]
    # a promoted mirror carries the replica's watermark: the copy is
    # consistent at W, which may trail the manifest's last commit M.
    # Clamping to W makes the rollback below undo every committed step in
    # (W, M] from the replica's undo ring (commit-coupled, so it covers
    # that range), rows a torn refresh left newer included
    wm_region = mirror_dom.get("watermark")
    if wm_region is not None:
        wm = JsonRegion(wm_region).read() or {}
        if "step" in wm:
            mirror_step = min(int(mirror_step), int(wm["step"]))

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


def resume_train_state(rec: RecoveredState, init_state: dict,
                       rows: Optional[slice] = None) -> tuple[dict, int]:
    """Overlay recovered arrays onto a freshly initialised train state.

    Every recovered leaf becomes a new tensor on the device of the leaf it
    replaces, in that leaf's dtype (the f32 mirror of a bf16 table holds
    bf16 values, so the cast is exact). ``init_state`` is not modified,
    but where no dense snapshot was recovered the state keeps its dense
    leaves and moments, which training then updates in place. ``rows``:
    the rows of each table (``rec.table_shape`` (T, R, d)) that the state
    holds, a rank's block under a mesh (an LM's (V, d) table: its rows);
    only they are taken from the mirror. Returns (state, resume_step).
    """
    def like(tgt: torch.Tensor, src) -> torch.Tensor:
        return torch.as_tensor(src).to(device=tgt.device, dtype=tgt.dtype,
                                       copy=True).reshape(tgt.shape)

    state = dict(init_state)
    tgt = init_state["embed"][rec.table_name]
    src = rec.embed_rows
    if rows is not None:
        src = np.asarray(src).reshape(rec.table_shape)[..., rows, :]
    state["embed"] = {rec.table_name: like(tgt, src)}
    if rec.dense is not None:
        for key in ("dense", "opt_dense", "opt_embed"):
            state[key] = tree_map(like, init_state[key], rec.dense[key])
    state["step"] = torch.tensor(rec.mirror_step + 1, dtype=torch.int32,
                                 device=tgt.device)
    state["prefetch"] = None   # the relaxed carry is rebuilt by warmup
    return state, rec.mirror_step + 1
