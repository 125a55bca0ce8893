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
and a few headers cross the socket.

``pool_backend="sharded"`` spreads the domains over the nodes of
``pool_shards`` (``pool.sharded.ShardedPool``; ``pool_placement`` pins
domains). POOL.json records the placement, and every epoch flip publishes
through ``record_placement``. On the writer thread, after each tier-E
commit: the read replica of the mirror is refreshed on shard
``pool_replica`` every ``pool_replica_every`` steps; the committed undo
slot (and, without a quorum, the manifest) ships to shard
``pool_ckpt_replica``; the capacity rebalancer (``pool_rebalance``) may
migrate a domain. With ``pool_manifest_quorum`` on three or more nodes two
witness copies of the manifest live on other nodes, and recovery elects
the 2-of-3 majority. A failure of a replica or a witness degrades the
redundancy (``stats`` counts it, one line is printed) and never stops
training: the primary has committed.

A model whose head is tied to its token table (whisper) is refused: every
step moves every row of the table, which tier-E's touched-row logging
cannot mirror (the reference logs the batch's tokens only, and its mirror
goes stale at every other row).
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
                                     make_pool)
from repro_torch.pool.faults import FaultSchedule, InjectedCrash
from repro_torch.pool.nmp import NmpQueue
from repro_torch.pool.placement import RebalancePolicy
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
        if getattr(cfg, "tie_embeddings", False):
            raise NotImplementedError(
                f"{cfg.name}: its head is tied to the token table, so every step "
                "updates every row of the table; tier-E logs the rows a batch "
                "touches, so the mirror would go stale at the others (the "
                "reference's does). Checkpointing a tied head is not supported.")
        self.cfg = cfg
        self.ccfg = ckpt_cfg
        self.root = ckpt_cfg.directory
        if pool is None:    # refuse what cannot open before anything starts
            backend = check_backend(getattr(ckpt_cfg, "pool_backend", "pmem"))
            if backend == "remote" and not getattr(ckpt_cfg, "pool_addr", ""):
                raise PoolError("remote backend needs a server addr "
                                "(unix:/path or tcp:host:port)")
            if backend == "sharded" and not getattr(ckpt_cfg, "pool_shards", ""):
                raise PoolError("sharded backend needs shard addrs "
                                "(--pool-shards addr1,addr2,...)")
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
        self._man_witnesses: list = []
        self._ship_gen: Optional[int] = None
        self._degraded_warned = False
        self._q: queue.Queue = queue.Queue(maxsize=8)
        self._err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.stats = {"tier_e": 0, "tier_m": 0, "tier_m_skipped": 0,
                      "bytes_e": 0, "bytes_m": 0,
                      "undo_raw_bytes": 0, "undo_stored_bytes": 0,
                      "dense_stored_bytes": 0,
                      "migrations": 0, "migration_link_bytes": 0,
                      "replica_refreshes": 0, "replica_link_bytes": 0,
                      "replica_refresh_failures": 0,
                      "ship_steps": 0, "ship_link_bytes": 0,
                      "ship_full_refreshes": 0,
                      "manifest_witness_failures": 0}
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
                shards=getattr(self.ccfg, "pool_shards", ""),
                placement=getattr(self.ccfg, "pool_placement", ""),
                rebalance=float(getattr(self.ccfg, "pool_rebalance", 0.0)
                                or 0.0),
                secret=getattr(self.ccfg, "pool_secret", ""),
                timeout=getattr(self.ccfg, "pool_timeout", None))
            # POOL.json lets recovery reopen the same pool: pmem by its
            # image, remote by reconnecting to the node that outlived the
            # trainer, as the same tenant with the same quota (the tcp
            # secret is read from the environment again, never stored); a
            # sharded pool by its resolved placement (record_placement
            # below), so recovery reconnects every node and replays the
            # epochs to the same assignment. The keys are the JAX
            # package's: either package reads them.
            info = {"backend": backend, "addr": addr, "tenant": tenant,
                    "quota": quota,
                    "manifest_quorum": bool(getattr(
                        self.ccfg, "pool_manifest_quorum", False)),
                    "ckpt_replica": int(getattr(
                        self.ccfg, "pool_ckpt_replica", -1))}
            store.write_json_atomic(
                os.path.join(self.root, "POOL.json"), info)
        if self._sharded():
            # the durable half of every epoch flip goes through here
            self.pool.epoch_sink = self.record_placement
            reb = float(getattr(self.ccfg, "pool_rebalance", 0.0) or 0.0)
            if reb > 0 and self.pool.rebalance is None:
                self.pool.rebalance = RebalancePolicy(high=reb)
            self.record_placement()
        self._alloc = PoolAllocator(self.pool)
        self.manifest = JsonRegion.create(self._alloc.domain("manifest"),
                                          "manifest")
        self.compress = getattr(self.ccfg, "pool_compress", "zlib")
        self._open_witnesses()
        self.ring = UndoRing(self._alloc, self.ccfg.max_undo_logs,
                             compress=self.compress)
        self.nmp = NmpQueue(self.pool)
        self.dense_dom = self._alloc.domain("dense")

    def _sharded(self) -> bool:
        return getattr(self.pool, "backend", "") == "sharded"

    def _open_witnesses(self):
        """The 2-of-3 manifest quorum (sharded, three nodes or more): two
        witness copies of the manifest (``manifest@w1``, ``manifest@w2``)
        are pinned to the two shards after the primary's, so the three
        copies live on distinct nodes and the loss of any one leaves a
        majority. The pins ride in the published placement; recovery finds
        the witnesses there and elects by sealed sequence number."""
        self._man_witnesses = []
        if not bool(getattr(self.ccfg, "pool_manifest_quorum", False)) \
                or not self._sharded() or self.pool.nshards < 3:
            return
        primary = self.pool.placement.place("manifest")
        pinned = False
        for k in (1, 2):
            wdom = f"manifest@w{k}"
            if self.pool.placement.explicit(wdom) is None:
                self.pool.placement = self.pool.placement.with_pin(
                    wdom, (primary + k) % self.pool.nshards)
                pinned = True
            try:
                self._man_witnesses.append(
                    JsonRegion.create(self._alloc.domain(wdom), "manifest"))
            except PoolError as e:      # a lost witness shard: 2 of 3 hold
                self._degraded("manifest_witness_failures", e)
        if pinned:
            self.record_placement()

    def _man_write(self, man: dict, point: str):
        """Advance the manifest: the primary copy first (the one a recovery
        without a quorum elects), then the witnesses. A dead witness is
        counted and skipped, never fatal."""
        self.manifest.write(man, point=point)
        for w in self._man_witnesses:
            try:
                w.write(man, point="manifest-witness")
            except PoolError as e:
                self._degraded("manifest_witness_failures", e)

    def _degraded(self, key: str, err: BaseException):
        """A failure on the replication side (a dead replica destination,
        a lost witness shard) degrades the redundancy, never training: the
        primary has committed, only the extra copy is behind. Counted each
        time, printed once."""
        self.stats[key] += 1
        if not self._degraded_warned:
            self._degraded_warned = True
            print(f"[ckpt] replication degraded (training continues): {err}")

    def _hit(self, point: str):
        """Manager-level fault point (between pipeline stages)."""
        if self.faults is not None:
            if self.faults.hit(point) == "crash-after":
                raise InjectedCrash(point, self.faults.counts[point])

    def record_placement(self, placement=None):
        """Publish the pool's placement map into POOL.json, the commit point
        of every epoch flip: the whole new file replaces the old one in one
        atomic rename, and every epoch record carries its own CRC, so
        recovery reads either the placement before the flip or the one
        after it (a torn tail record falls back to the previous epoch)."""
        pm = placement if placement is not None else self.pool.placement
        path = os.path.join(self.root, "POOL.json")
        try:
            info = store.read_json(path)
        except (OSError, ValueError):
            info = {"backend": "sharded",
                    "tenant": getattr(self.ccfg, "pool_tenant", "default"),
                    "quota": getattr(self.ccfg, "pool_quota", 0)}
        pj = pm.to_json()
        info.update(shards=pj["shards"], placement=pj["pin"],
                    epochs=pj["epochs"])
        store.write_json_atomic(path, info)

    def _maybe_rebalance(self, step: int):
        """Capacity-watermark rebalancing (writer thread, after a tier-E
        commit): at the policy's cadence, read the shards' used/capacity
        gauges and run any migration it proposes (copy, epoch flip through
        ``record_placement``, source GC), then rebind the region handles
        the move invalidated."""
        pol = getattr(self.pool, "rebalance", None)
        if pol is None or not pol.due(step):
            return
        for mig in pol.propose(self.pool):
            info = self.pool.migrate_domain(mig.domain, mig.dst,
                                            compress=self.compress)
            self.rebind_domains(info["moved"])
            self.stats["migrations"] += 1
            self.stats["migration_link_bytes"] += info["link_bytes"]

    def _maybe_replicate(self, step: int):
        """Refresh the read replica of the mirror on shard ``pool_replica``
        (sharded only) every ``pool_replica_every`` committed steps, and
        stamp it with the commit's step: the cadence is the replica's
        declared staleness bound. A dead destination degrades; an injected
        crash is not caught (it is the drill's power event)."""
        if not self._sharded():
            return
        dst = int(getattr(self.ccfg, "pool_replica", -1))
        every = max(1, int(getattr(self.ccfg, "pool_replica_every", 1)))
        if dst >= 0 and step % every == 0:
            try:
                info = self.pool.replicate_domain("embedding-mirror", dst,
                                                  compress=self.compress,
                                                  watermark=step)
                self.stats["replica_refreshes"] += 1
                self.stats["replica_link_bytes"] += info["link_bytes"]
                self.pool.metrics.record_replica(info["link_bytes"])
            except PoolError as e:
                self._degraded("replica_refresh_failures", e)
        self._maybe_ship(step)

    def _maybe_ship(self, step: int):
        """Commit-coupled replication of the checkpoint domains onto shard
        ``pool_ckpt_replica`` (sharded only): ``undo-log``, and the
        manifest when no quorum stands. The first ship, and any ring
        regrowth, copies the whole ring (``replicate_domain``); every
        commit after it ships only the committed slot's bytes
        (``UndoRing.slot_image``) and the small manifest image, so the
        replica trails the primary by at most the step in flight."""
        dst = int(getattr(self.ccfg, "pool_ckpt_replica", -1))
        if dst < 0 or not self._sharded():
            return
        try:
            if self._ship_gen != self.ring.gen:
                info = self.pool.replicate_domain("undo-log", dst,
                                                  compress=self.compress,
                                                  watermark=step)
                self.stats["ship_full_refreshes"] += 1
                self.stats["ship_link_bytes"] += info["link_bytes"]
                self._ship_gen = self.ring.gen
            else:
                img = self.ring.slot_image(step)
                if img is None:
                    raise PoolError(f"undo slot for step {step} vanished "
                                    "before shipping")
                name, slot_off, buf = img
                self.stats["ship_link_bytes"] += \
                    self.pool.ship_slot("undo-log", name, slot_off, buf)
            if not self._man_witnesses:
                info = self.pool.replicate_domain("manifest", dst,
                                                  compress=self.compress,
                                                  watermark=step)
                self.stats["ship_link_bytes"] += info["link_bytes"]
            self.stats["ship_steps"] += 1
        except PoolError as e:
            self._degraded("replica_refresh_failures", e)

    def rebind_domains(self, moved):
        """Resolve the region handles again after the ``moved`` domains
        changed shards (their global offsets name the new node)."""
        moved = set(moved)
        if "embedding-mirror" in moved \
                and getattr(self, "mirror_region", None) is not None:
            self.mirror_region = \
                self._alloc.domain("embedding-mirror").get("rows")
        if "undo-log" in moved and self.ring is not None:
            self.ring = UndoRing(self._alloc, self.ccfg.max_undo_logs,
                                 compress=self.compress)
        if "manifest" in moved and self.manifest is not None:
            region = self._alloc.domain("manifest").get("manifest")
            if region is not None:
                self.manifest = JsonRegion(region)

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
        tab = embed[relaxed.embed_leaf(self.cfg)]
        src = tab.detach().reshape(-1, tab.shape[-1])
        flat = np.empty(tuple(src.shape), dtype=np.float32)
        for s in range(0, src.shape[0], _LOAD_ROWS):  # bounds the f32 temp
            flat[s:s + _LOAD_ROWS] = src[s:s + _LOAD_ROWS].float().cpu().numpy()
        self.load_mirror(flat, tuple(tab.shape), step)

    def load_mirror(self, flat: np.ndarray, table_shape: tuple, step: int = -1):
        """``init_mirror`` from the tables' rows already on the host: ``flat``
        the (rows, d) f32 image of a leaf of ``table_shape`` (a writer that
        gathered it from the ranks' blocks hands it in whole)."""
        name = relaxed.embed_leaf(self.cfg)
        self.table_shape = tuple(table_shape)
        if self._alloc is None:
            self._open_pool(2 * flat.nbytes + (1 << 20))
        dom = self._alloc.domain("embedding-mirror")
        # a promoted mirror still carries the replica's watermark; once
        # training re-anchors the mirror at ``step`` that stamp is stale,
        # and left in place it would clamp a later recovery back to it
        if dom.get("watermark") is not None:
            dom.free_region("watermark")
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

    def on_step(self, step: int, state: dict, feed: Optional[dict],
                new_rows=None):
        """Called by the train loop after step N, before step N+1 updates
        the tables. Copies what the writer needs to the host and enqueues
        it (blocks only when the writer is 8 items behind). ``new_rows``:
        the touched rows as updated, in the feed's id order (a writer that
        gathered them from the ranks' blocks); by default they are gathered
        here from ``state``'s tables."""
        self._raise_writer_err()
        if feed is None:   # strict step: no feed, nothing logged
            return
        ids, idx = touched_rows(feed)
        if new_rows is None:
            tab = state["embed"][relaxed.embed_leaf(self.cfg)]
            new_rows = ops.gather_rows(tab.view(-1, tab.shape[-1]), ids)
        new_rows = new_rows.float().cpu().numpy()
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
        self._maybe_replicate(step)
        self._maybe_rebalance(step)

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
