"""Two-tier asynchronous checkpoint manager over the emulated memory pool
(counterpart of ``repro.core.checkpoint.manager``; same pool layout).

All persistent state lives in named pool domains of one ``PoolDevice``:

    embedding-mirror/rows   the data region (host f32 mirror of the tables)
    undo-log/*              the log region (per-step undo ring, COMMIT flags)
    manifest/manifest       A/B crash-atomic manifest (mirror/dense steps)
    dense/slot{0,1}         double-buffered dense snapshot blobs

Tier-E (embedding pool, every relaxed step):
    0. on the card, ``on_step`` gathers the rows the step touched from the
       updated tables (the ``gather_rows`` kernel), widens them to f32 and
       copies them to the host. The port updates its tables in place, so
       this copy is made before the next step runs and the writer thread
       never sees a device tensor.
    1-3. ONE fused near-memory op (``UndoRing.log_and_apply``): the pool
       snapshots the touched mirror rows into the log slot, compresses them,
       persists payload + COMMIT flag with the two paper barriers, then
       applies the new rows. Only (step, idx, new_rows) cross the link.
    4. advance the manifest (A/B slot write).

Tier-M (dense params and optimizer state, every K steps): the tree is
serialized to a CRC'd blob (bf16 leaves as their raw bits) and written to
the dense slot the manifest does NOT point at; the manifest flips to it
only after the blob persists. May trail tier-E by up to K steps.

Pool work runs on a background writer thread; ``flush()`` drains it.
``add_commit_hook(fn)`` registers ``fn(step, idx)``, called on the writer
thread once a tier-E commit's manifest advance is durable: the serving tier
evicts exactly the touched rows from its hot-row cache there.

``pool_backend="remote"`` checkpoints into a memory node in another process
(``repro_torch.pool.server`` at ``pool_addr``) as tenant ``pool_tenant``:
the fused op runs inside the node, so per step only (step, idx, new_rows)
and a few headers cross the socket. The JAX package's manifest witnesses,
placement records, rebalancing and replication serve its sharded pools,
and are not ported.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import relaxed
from repro_torch.core.checkpoint import store
from repro_torch.core.checkpoint.undo_log import UndoRing
from repro_torch.kernels import ops
from repro_torch.pool import compress as pool_compress
from repro_torch.pool.allocator import JsonRegion, PoolAllocator
from repro_torch.pool.device import (PoolDevice, PoolError, check_backend,
                                     check_checker_off, make_pool)
from repro_torch.pool.faults import FaultSchedule, InjectedCrash
from repro_torch.pool.nmp import NmpQueue
from repro_torch.tree import tree_map


_LOAD_ROWS = 1 << 20   # rows widened to f32 per copy in init_mirror


def touched_rows(feed: dict):
    """The distinct flat row ids of a relaxed step's feed.

    ``feed["touched"]`` is the step's ``uniq``: (N,) int32 on the tables'
    device, the distinct ids ascending, then -1 pads. Returns ``(ids,
    idx)``: the ids without pads on that device, and the same ids as a host
    int64 array, the array the JAX package logs (``np.unique`` of the
    batch's flat ids)."""
    uniq = feed["touched"]
    n = int(torch.count_nonzero(uniq >= 0))
    ids = uniq[:n]
    return ids, ids.cpu().numpy().astype(np.int64)


def undo_image(feed: dict):
    """Host copy of a relaxed step's undo image: ``(idx, rows)``, the ids of
    ``touched_rows`` and the pre-update rows that the fused update captured
    on the card (``feed["old_rows"]``), pads dropped, widened to f32 as the
    pool's mirror holds them."""
    _, idx = touched_rows(feed)
    return idx, feed["old_rows"][:idx.size].float().cpu().numpy()


def check_undo_images(ring: UndoRing, images: dict) -> int:
    """Holds the undo entry of every step the ring still commits against
    ``images[step]`` (``undo_image`` of that step's feed), bitwise.

    The pool captures its image from the mirror (``nmp.undo_log_append``),
    the card from the tables, so equality shows that the mirror was in step
    with the tables before each logged update. Needs lossless undo payloads
    (``pool_compress`` none or zlib). Returns the count of steps checked;
    raises ``RuntimeError`` for a step that has no image or differs.
    """
    steps = ring.committed_steps()
    for step in steps:
        if step not in images:
            raise RuntimeError(f"undo entry of step {step}: no device image")
        got, (idx, rows) = ring.read(step), images[step]
        if got is None or not (
                np.array_equal(got[0], idx)
                and np.array_equal(np.asarray(got[1]).view(np.uint32),
                                   rows.view(np.uint32))):
            raise RuntimeError(f"undo entry of step {step} differs from the "
                               "image the update captured on the device")
    return len(steps)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class CheckpointManager:
    def __init__(self, cfg, ckpt_cfg, *, embed_init: Optional[dict] = None,
                 pool: Optional[PoolDevice] = None,
                 faults: Optional[FaultSchedule] = None):
        self.cfg = cfg
        self.ccfg = ckpt_cfg
        self.root = ckpt_cfg.directory
        if pool is None:    # refuse what cannot open before anything starts
            backend = check_backend(getattr(ckpt_cfg, "pool_backend", "pmem"))
            check_checker_off()
            if backend == "remote" and not getattr(ckpt_cfg, "pool_addr", ""):
                raise PoolError("remote backend needs a server addr "
                                "(unix:/path or tcp:host:port)")
        os.makedirs(self.root, exist_ok=True)
        self.pool = pool
        self.faults = faults
        if pool is not None and faults is not None and pool.faults is None:
            pool.faults = faults
        self._alloc: Optional[PoolAllocator] = None
        self.ring: Optional[UndoRing] = None
        self.manifest: Optional[JsonRegion] = None
        self.nmp: Optional[NmpQueue] = None
        self._commit_hooks: list = []
        self._q: queue.Queue = queue.Queue(maxsize=8)
        self._err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.stats = {"tier_e": 0, "tier_m": 0, "tier_m_skipped": 0,
                      "bytes_e": 0, "bytes_m": 0,
                      "undo_raw_bytes": 0, "undo_stored_bytes": 0,
                      "dense_stored_bytes": 0}
        if embed_init is not None:
            self.init_mirror(embed_init)

    # -- pool plumbing -------------------------------------------------------
    def _open_pool(self, capacity_hint: int):
        if self.pool is None:
            backend = getattr(self.ccfg, "pool_backend", "pmem")
            addr = getattr(self.ccfg, "pool_addr", "")
            tenant = getattr(self.ccfg, "pool_tenant", "default")
            quota = getattr(self.ccfg, "pool_quota", 0)
            self.pool = make_pool(
                backend, path=os.path.join(self.root, "pool.img"),
                capacity=capacity_hint, faults=self.faults, addr=addr,
                tenant=tenant, quota=quota,
                secret=getattr(self.ccfg, "pool_secret", ""),
                timeout=getattr(self.ccfg, "pool_timeout", None))
            # POOL.json lets recovery reopen the same pool: pmem by its
            # image, remote by reconnecting to the node that outlived the
            # trainer, as the same tenant with the same quota (the tcp
            # secret is read from the environment again, never stored).
            # The keys are the JAX package's: either package reads them.
            info = {"backend": backend, "addr": addr, "tenant": tenant,
                    "quota": quota, "manifest_quorum": False,
                    "ckpt_replica": -1}
            store.write_json_atomic(
                os.path.join(self.root, "POOL.json"), info)
        self._alloc = PoolAllocator(self.pool)
        self.manifest = JsonRegion.create(self._alloc.domain("manifest"),
                                          "manifest")
        self.compress = getattr(self.ccfg, "pool_compress", "zlib")
        self.ring = UndoRing(self._alloc, self.ccfg.max_undo_logs,
                             compress=self.compress)
        self.nmp = NmpQueue(self.pool)
        self.dense_dom = self._alloc.domain("dense")

    def _man_write(self, man: dict, point: str):
        """Advance the manifest (the primary copy: the port has no quorum
        witnesses)."""
        self.manifest.write(man, point=point)

    def _hit(self, point: str):
        """Manager-level fault point (between pipeline stages)."""
        if self.faults is not None:
            if self.faults.hit(point) == "crash-after":
                raise InjectedCrash(point, self.faults.counts[point])

    @property
    def mirror_rows(self) -> np.ndarray:
        """Writable view of the data region (cache side)."""
        return self.mirror_region.view_array()

    # -- data region ---------------------------------------------------------
    def init_mirror(self, embed: dict, step: int = -1):
        """Materialise the persistent data region from the tables: one copy
        to a host f32 array, made before the first step updates them. The
        manifest names the leaf (``relaxed.embed_leaf``: "emb_tables" for
        DLRM, "table" for an LM), as the JAX package's does."""
        name = relaxed.embed_leaf(self.cfg)
        tab = embed[name]
        src = tab.detach().reshape(-1, tab.shape[-1])
        flat = np.empty(tuple(src.shape), dtype=np.float32)
        for s in range(0, src.shape[0], _LOAD_ROWS):  # bounds the f32 temp
            flat[s:s + _LOAD_ROWS] = src[s:s + _LOAD_ROWS].float().cpu().numpy()
        self.table_shape = tuple(tab.shape)
        if self._alloc is None:
            self._open_pool(2 * flat.nbytes + (1 << 20))
        dom = self._alloc.domain("embedding-mirror")
        self.mirror_region = dom.alloc("rows", shape=flat.shape,
                                       dtype="float32")
        self.mirror_region.write_array(flat, tag="mirror-load")
        self.mirror_region.persist(point="mirror-load")
        man = self.manifest.read() or {"dense_step": -1, "dense_slot": 0,
                                       "dense_len": 0}
        man.update(mirror_step=step, table_name=name,
                   table_shape=list(self.table_shape),
                   max_undo_logs=self.ccfg.max_undo_logs)
        self._man_write(man, point="manifest-init")

    # -- hooks ---------------------------------------------------------------
    def add_commit_hook(self, fn):
        """Register fn(step, idx) to run on the writer thread right after a
        tier-E commit's manifest advance, the point at which step N's rows
        are durably applied to the mirror. The serving tier uses this to
        invalidate exactly the touched hot-cache rows."""
        self._commit_hooks.append(fn)

    def _raise_writer_err(self):
        if self._err is not None:
            err = self._err
            if isinstance(err, InjectedCrash):
                raise err
            raise RuntimeError("checkpoint writer failed") from err

    def on_step(self, step: int, state: dict, feed: Optional[dict]):
        """Called by the train loop after step N, before step N+1 updates
        the tables. Copies what the writer needs to the host and enqueues
        it (blocks only when the writer is 8 items behind)."""
        self._raise_writer_err()
        if feed is None:   # strict step: no feed, nothing logged
            return
        ids, idx = touched_rows(feed)
        tab = state["embed"][relaxed.embed_leaf(self.cfg)]
        flat_tab = tab.view(-1, tab.shape[-1])
        new_rows = ops.gather_rows(flat_tab, ids).float().cpu().numpy()
        self._q.put(("tier_e", step, idx, new_rows))
        if (self.ccfg.dense_interval > 0
                and step % self.ccfg.dense_interval == 0):
            dense_np = tree_map(_host_copy, {
                "dense": state["dense"], "opt_dense": state["opt_dense"],
                "opt_embed": state["opt_embed"]})
            self._q.put(("tier_m", step, dense_np, time.monotonic()))

    def flush(self):
        self._q.join()
        self._raise_writer_err()

    def close(self):
        """Drain, end the writer thread and close the pool. Raises what the
        writer raised (an ``InjectedCrash`` after a drill) once everything
        is released."""
        try:
            self.flush()
        finally:
            self._q.put(None)           # the writer's stop sentinel
            if self.pool is not None:
                self.pool.close()

    # -- writer thread -------------------------------------------------------
    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                if self._err is not None:
                    continue           # crashed: the machine is down
                if item[0] == "tier_e":
                    self._do_tier_e(*item[1:])
                else:
                    self._do_tier_m(*item[1:])
            except BaseException as e:  # surfaced on next on_step/flush
                self._err = e
            finally:
                self._q.task_done()

    def _do_tier_e(self, step: int, idx: np.ndarray, new_rows: np.ndarray):
        # 1-3: fused near-memory op; the commit/apply crash window lives
        # inside it (fault point "tier_e.between-commit-and-apply")
        info = self.ring.log_and_apply(step, self.mirror_region, idx,
                                       new_rows)
        self._hit("tier_e.between-apply-and-manifest")
        # 4: persistent step flag
        man = self.manifest.read()
        man["mirror_step"] = step
        self._man_write(man, point="manifest-advance")
        self.ring.gc(step - self.ccfg.max_undo_logs)
        self.stats["tier_e"] += 1
        self.stats["bytes_e"] += idx.nbytes + new_rows.nbytes
        self.stats["undo_raw_bytes"] += info.get("raw", 0)
        self.stats["undo_stored_bytes"] += info.get("stored", 0)
        for hook in self._commit_hooks:
            hook(step, idx)

    def _do_tier_m(self, step: int, dense_np: dict, t_enq: float):
        if (self.ccfg.writer_deadline_s
                and time.monotonic() - t_enq > self.ccfg.writer_deadline_s):
            self.stats["tier_m_skipped"] += 1      # relaxed ckpt: never block
            return
        blob = store.serialize_tree(dense_np, {"step": step})
        man = self.manifest.read()
        slot = 1 - man.get("dense_slot", 1)        # write the spare slot
        # the pool stores a framed (possibly compressed) image; size the
        # region for the frame's worst case (mode falls back to raw)
        need = pool_compress.framed_len(len(blob))
        cap = max(need, 1 << 12)
        region = self.dense_dom.get(f"slot{slot}")
        if region is None or region.nbytes < need:
            if region is not None:
                self.dense_dom.free_region(f"slot{slot}")
            region = self.dense_dom.alloc(
                f"slot{slot}", shape=(int(cap * 1.5),), dtype="uint8")
        stored = self.nmp.blob_put(region, blob, compress=self.compress,
                                   point="dense-blob")
        man.update(dense_step=step, dense_slot=slot, dense_len=stored)
        self._man_write(man, point="manifest-dense")
        self.stats["tier_m"] += 1
        self.stats["bytes_m"] += len(blob)
        self.stats["dense_stored_bytes"] += stored
