"""Checkpointing and recovering a model trained under a mesh through one
writer: DLRM, and the decoders (dense, MoE, jamba) with tensor
parallelism, expert parallelism and FSDP.

The reference's checkpoint manager knows no mesh: it mirrors the global
(T * R, d) tables (an LM's (V, d) token table) and logs the global batch's
touched rows. Under a mesh
the port keeps that layout, one f32 mirror and one undo ring, so that a
checkpoint stays exchangeable between the packages and ``recover`` is
unchanged; the rank at coordinate 0 on every axis is the writer and holds
the ``CheckpointManager``.

* ``MeshCheckpoint.init_mirror``: the writer loads the global mirror from
  the ranks' blocks, each block moved once, in pieces no larger than the
  wire's split (``pool.remote.chunk_bytes()``, 64 MiB).
* ``MeshCheckpoint.on_step``: the ranks that hold the blocks of one copy of
  the tables (coordinate 0 on every axis but the ``table_rows`` axis)
  gather their updated rows (the gather-rows kernel on the block, at the
  feed's block-local ids), map those ids into the (T * R, d) stacked
  tables, and gather the feeds (ids, deltas, undo images, each padded to
  the batch's item count by the trainer) and the rows to the writer,
  which merges them into ascending ids with the pads last: the feed a
  one-rank run would give. An LM is one table of V rows (T = 1), its
  block over the ``vocab`` axes.
  Tier-M writes the dense tree and the optimizer state from the writer
  alone: whole on every rank, or where the ranks hold blocks of it gathered
  whole from them first, leaf by leaf to the writer's host, over every
  axis a leaf's held spec names (under tensor parallelism the ranks at
  data coordinate 0 take part, under FSDP every rank, each holding a
  block of its own), so that the blob has the one-rank layout that
  ``store.serialize_tree`` writes and either package recovers.
* ``recover_on_mesh``: the writer runs ``recover`` (rollback included),
  then every rank takes its block of the recovered mirror and the dense
  tree from it (where it holds blocks of the dense leaves and their
  moments, cut again by their held spec and sent block by block); the
  relaxed carry is rebuilt by the trainer's warm-up.

Where a rank holds the tables whole (no ``table_rows`` axis in the mesh)
the writer has every row and checkpoints alone. Every method is called by
every rank, in the same order; the collectives go through the mesh's
helpers. A writer that fails (an injected crash) raises on its next
``on_step`` or ``flush`` while the others go on: a drill ends every rank at
one scheduled step, and ``mesh.spawn``'s timeout ends a rank left waiting.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import relaxed as rx
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.distributed import fsdp, sharding
from repro_torch.kernels import ops
from repro_torch.pool.remote import chunk_bytes
from repro_torch.tree import tree_map_with_path


class _Layout:
    """Where the tables lie on the mesh, read from the current context:
    the writer, the ``table_rows`` (an LM's ``vocab``) axis (``tp_ax``,
    None where the rank holds the tables whole), the other axes (``rest``)
    and whether this rank sends its block to the writer. ``shape`` is the
    one-rank checkpoint's table shape; ``view`` shows a held table as (T,
    R_held, d)."""

    def __init__(self, cfg, table):
        ctx = sharding.current()
        if ctx is None:
            raise RuntimeError("a mesh checkpoint needs a sharding context")
        rx.check_trainable(cfg)
        mesh = self.mesh = ctx.mesh
        dlrm = cfg.arch_type == "dlrm"
        if dlrm:
            self.T, self.R_held, self.d = table.shape
        else:
            self.T, (self.R_held, self.d) = 1, table.shape
        self.R, self.base, psum = rx.block(cfg, table)
        self.shape = (self.T, self.R, self.d) if dlrm else (self.R, self.d)
        self.tp_ax = ctx.axes("table_rows" if dlrm else "vocab") \
            if psum is not None else None
        self.rest = tuple(a for a in mesh.axis_names if a != self.tp_ax)
        self.writer = mesh.axis_index(mesh.axis_names) == 0
        self.sender = all(mesh.coords[a] == 0 for a in self.rest)
        self.tp = mesh.axis_size(self.tp_ax)
        self.piece = max(1, chunk_bytes() // (self.d * table.element_size()))

    def pieces(self):
        """(table, first row, end row) of a block, in pieces of at most
        ``chunk_bytes()``."""
        for t in range(self.T):
            for s in range(0, self.R_held, self.piece):
                yield t, s, min(s + self.piece, self.R_held)

    def rest_group(self):
        return self.rest[0] if len(self.rest) == 1 else self.rest

    def view(self, table):
        return table.view(self.T, self.R_held, self.d)


def _whole_leaves(tree, cfg, to_host=False):
    """``tree`` (dense params or their moments) with every block
    all-gathered whole over the axes its rank holds it by (the TP axis, and
    ``data`` too under FSDP; every rank of those axes calls it). With
    ``to_host`` each gathered leaf is moved to the host at once on the
    writer and dropped on the others (None), so that no rank holds the
    whole tree on the card."""
    ctx = sharding.current()
    writer = ctx.mesh.axis_index(ctx.mesh.axis_names) == 0

    def whole(path, x):
        dims = fsdp.held_dims(cfg, path, x.dim())
        got = ctx.mesh.all_gather_blocks(x, dims) if dims else x
        if not to_host:
            return got
        return got.detach().to("cpu", copy=True) if writer else None
    return tree_map_with_path(whole, tree)


def _held_axes(cfg, tree) -> set:
    """The mesh axes over which a rank holds blocks of some leaf of
    ``tree``."""
    axes = set()
    tree_map_with_path(lambda path, x: axes.update(
        fsdp.held_dims(cfg, path, x.dim()).values()), tree)
    return axes


def _send_blocks(like, cfg, src=None):
    """Every rank's blocks of a recovered tree, sent by the writer: ``src``
    (the writer's whole leaves, host arrays; None on the other ranks) laid
    out as ``like`` (this rank's held tree). A leaf held whole is broadcast
    whole; a blocked one block by block, each cut on the host and sent to
    every rank, the ranks it belongs to keeping it, so that no rank holds a
    whole dense leaf on the card."""
    ctx = sharding.current()
    mesh = ctx.mesh

    def on_card(x, mine):
        return torch.as_tensor(x).to(device=mine.device, dtype=mine.dtype)

    def send(path, mine, whole=None):
        dims = fsdp.held_dims(cfg, path, mine.dim())
        if not dims:
            buf = torch.empty_like(mine) if whole is None \
                else on_card(whole, mine).reshape(mine.shape)
            return mesh.broadcast(buf, mesh.axis_names, 0)
        axes = tuple(a for a in mesh.axis_names if a in dims.values())
        shape = list(mine.shape)
        for d, ax in dims.items():
            shape[d] *= mesh.sizes[ax]
        kept = None
        for pos in itertools.product(*(range(mesh.sizes[a]) for a in axes)):
            at = dict(zip(axes, pos, strict=True))
            if whole is None:
                buf = torch.empty_like(mine)
            else:
                cut = [slice(None)] * mine.dim()
                for d, ax in dims.items():
                    cut[d] = slice(at[ax] * mine.shape[d], (at[ax] + 1) * mine.shape[d])
                block = torch.as_tensor(whole).reshape(shape)[tuple(cut)]
                buf = on_card(block.contiguous(), mine)
            got = mesh.broadcast(buf, mesh.axis_names, 0)
            if all(mesh.coords[a] == i for a, i in at.items()):
                kept = got
        return kept
    if src is None:
        return tree_map_with_path(send, like)
    return tree_map_with_path(send, like, src)


def _pack(parts):
    return torch.cat([p.contiguous().reshape(-1).view(torch.uint8) for p in parts])


def _unpack(buf, like, n: int):
    """The ``n`` ranks' copies of ``like``'s tensors from their gathered
    bytes ``buf``: a list of (n, *shape) tensors."""
    rows = buf.view(n, -1)
    out, at = [], 0
    for t in like:
        nb = t.numel() * t.element_size()
        out.append(rows[:, at:at + nb].contiguous().view(t.dtype)
                   .view(n, *t.shape))
        at += nb
    return out


class MeshCheckpoint:
    """The two-tier checkpoint of a model trained under the current sharding
    context, written by one rank (the module's docstring). Every rank makes
    one, with the same arguments; ``pool`` and ``faults`` reach the writer's
    ``CheckpointManager`` (``manager``, None on the other ranks). It stands
    in for a ``CheckpointManager`` in ``train_loop.train``."""

    def __init__(self, cfg, ckpt_cfg, *, embed_init: Optional[dict] = None,
                 pool=None, faults=None):
        ctx = sharding.current()
        if ctx is None:
            raise RuntimeError("MeshCheckpoint needs a sharding context")
        self.cfg, self.ccfg, self.mesh = cfg, ckpt_cfg, ctx.mesh
        self.writer = self.mesh.axis_index(self.mesh.axis_names) == 0
        self.manager = CheckpointManager(cfg, ckpt_cfg, pool=pool, faults=faults) \
            if self.writer else None
        self._hooks: list = []
        self.stats = {"mirror_load_s": 0.0, "gather_s": 0.0}
        if embed_init is not None:
            self.init_mirror(embed_init)

    def add_feed_hook(self, fn):
        """``fn(step, feed)`` on the writer, with each relaxed step's merged
        feed (the one-rank feed), before ``on_step`` enqueues it."""
        self._hooks.append(fn)

    def init_mirror(self, embed: dict, step: int = -1):
        """Loads the global mirror from the ranks' blocks (every rank
        calls it): each block other than the writer's moves once, piece by
        piece, over the ``table_rows`` axis. The seconds it took on this
        rank are ``stats["mirror_load_s"]``."""
        t0 = time.perf_counter()
        table = embed[rx.embed_leaf(self.cfg)]
        lay = _Layout(self.cfg, table)
        table = lay.view(table)
        if lay.tp_ax is None:
            if self.writer:
                self.manager.init_mirror(embed, step)
        elif lay.sender:
            flat = np.empty((lay.T * lay.R, lay.d), np.float32) if self.writer else None
            me = self.mesh.axis_index(lay.tp_ax)
            for j in range(lay.tp):
                for t, s, e in lay.pieces():
                    if j == 0:                 # the writer's own block
                        got = table[t, s:e] if self.writer else None
                    else:
                        buf = table[t, s:e] if me == j else table.new_empty((e - s, lay.d))
                        got = self.mesh.broadcast(buf, lay.tp_ax, j)
                    if self.writer:
                        at = t * lay.R + j * lay.R_held
                        flat[at + s:at + e] = got.float().cpu().numpy()
            if self.writer:
                self.manager.load_mirror(flat, lay.shape, step)
        self.stats["mirror_load_s"] = time.perf_counter() - t0

    def on_step(self, step: int, state: dict, feed: Optional[dict]):
        """After step N on every rank (the train loop's hook): the feeds and
        the updated rows of the blocks gathered and merged on the writer,
        which enqueues them as the one-rank manager does."""
        if feed is None:       # strict step: nothing logged
            if self.writer:
                self.manager.on_step(step, state, None)
            return
        state = self._dense_whole(step, state)
        table = state["embed"][rx.embed_leaf(self.cfg)]
        lay = _Layout(self.cfg, table)
        if lay.tp_ax is None:
            if self.writer:
                self._hand_on(step, state, feed, None)
            return
        if not lay.sender:
            return
        t0 = time.perf_counter()
        local = feed["touched"]          # ascending ids into the block, then pads
        n = int(torch.count_nonzero(local >= 0))
        new = table.new_zeros((local.shape[0], lay.d))
        new[:n] = ops.gather_rows(table.view(-1, lay.d), local[:n].contiguous())
        # table t, local row r of the block at ``base``: t * R + base + r
        u = local.long()
        ids = (torch.div(u, lay.R_held, rounding_mode="floor") * lay.R + lay.base
               + torch.remainder(u, lay.R_held))
        ids = torch.where(local >= 0, ids, -1).to(local.dtype)
        parts = (ids, feed["delta"], feed["old_rows"], new)
        got = self.mesh.all_gather(_pack(parts), lay.tp_ax, 0)
        if self.writer:
            g_ids, g_delta, g_old, g_new = (
                x.reshape(-1, *x.shape[2:]) for x in _unpack(got, parts, lay.tp))
            keep = torch.nonzero(g_ids >= 0).squeeze(1)
            keep = keep[torch.sort(g_ids[keep], stable=True)[1]]
            m = keep.shape[0]
            merged = {"touched": torch.full_like(ids, -1),
                      "delta": torch.zeros_like(feed["delta"]),
                      "old_rows": torch.zeros_like(feed["old_rows"])}
            merged["touched"][:m] = g_ids[keep]
            merged["delta"][:m] = g_delta[keep]
            merged["old_rows"][:m] = g_old[keep]
            self.stats["gather_s"] += time.perf_counter() - t0
            self._hand_on(step, state, merged, g_new[keep])

    def _dense_whole(self, step, state):
        """On a tier-M step where the ranks hold blocks of the dense tree
        (tensor parallelism, FSDP), the ranks that hold the blocks of one
        copy of it (coordinate 0 on every axis no block lies over; under
        FSDP every rank) gather it and its moments whole, leaf by leaf, to
        the writer's host; returns the writer's state with them, else
        ``state`` itself."""
        K = self.ccfg.dense_interval
        if K <= 0 or step % K:
            return state
        axes = _held_axes(self.cfg, state["dense"])
        if not axes or any(self.mesh.coords[a] for a in self.mesh.axis_names
                           if a not in axes):
            return state
        t0 = time.perf_counter()
        whole = {k: _whole_leaves(state[k], self.cfg, to_host=True)
                 for k in ("dense", "opt_dense")}
        self.stats["gather_s"] += time.perf_counter() - t0
        return {**state, **whole} if self.writer else state

    def _hand_on(self, step, state, feed, new_rows):
        for fn in self._hooks:
            fn(step, feed)
        self.manager.on_step(step, state, feed, new_rows=new_rows)

    def flush(self):
        if self.writer:
            self.manager.flush()

    def close(self):
        if self.writer:
            self.manager.close()


def recover_on_mesh(cfg, root: str, init_state: dict, *, pool=None):
    """Recovery at every rank of the current sharding context (each calls
    it with a fresh state of its own, ``init_state``): the writer runs
    ``recovery.recover(root, pool)``, rollback included; after a barrier
    every rank takes its block of the recovered mirror (moved once, in
    pieces, over the ``table_rows`` (``vocab``) axis and then over the
    others) and the dense tree (params and optimizer states, broadcast
    leaf by leaf; under tensor parallelism block by block, each rank
    keeping its own: ``_send_blocks``),
    overlaid by ``recovery.resume_train_state``. Returns (state, resume
    step, the writer's ``RecoveredState`` or None on the other ranks)."""
    leaf = rx.embed_leaf(cfg)
    table = init_state["embed"][leaf]
    lay = _Layout(cfg, table)
    mesh = lay.mesh
    world = mesh.axis_names
    rec = recovery.recover(root, pool) if lay.writer else None
    mesh.barrier()
    meta = torch.tensor([rec.mirror_step, rec.dense_step, rec.dense is not None,
                         rec.rolled_back] if lay.writer else [0, 0, 0, 0],
                        dtype=torch.int64, device=table.device)
    mirror_step, dense_step, has_dense, rolled = \
        (int(v) for v in mesh.broadcast(meta, world, 0).cpu())

    dense = None
    if has_dense:
        dense = {key: _send_blocks(init_state[key], cfg,
                                   rec.dense[key] if lay.writer else None)
                 for key in ("dense", "opt_dense", "opt_embed")}
    if lay.writer:
        mine = slice(0, lay.R_held) if lay.tp_ax is not None else None
        state, start = recovery.resume_train_state(
            dataclasses.replace(rec, dense=dense), init_state, rows=mine)
        held = state["embed"][leaf]
    else:
        held = torch.empty_like(table)
    block = lay.view(held)

    if lay.tp_ax is not None and lay.sender:
        me = mesh.axis_index(lay.tp_ax)
        for j in range(1, lay.tp):    # the writer's rows of block j to its rank
            for t, s, e in lay.pieces():
                at = t * lay.R + j * lay.R_held
                buf = (torch.from_numpy(np.ascontiguousarray(rec.embed_rows[at + s:at + e]))
                       .to(device=block.device, dtype=block.dtype)) if lay.writer \
                    else block.new_empty((e - s, lay.d))
                got = mesh.broadcast(buf, lay.tp_ax, 0)
                if me == j:
                    block[t, s:e] = got
    rest = lay.rest_group()
    if mesh.axis_size(rest) > 1:      # each block to the ranks of its column
        first = mesh.axis_index(rest) == 0
        for t, s, e in lay.pieces():
            buf = block[t, s:e] if first else block.new_empty((e - s, lay.d))
            got = mesh.broadcast(buf, rest, 0)
            if not first:
                block[t, s:e] = got

    if lay.writer:
        return state, start, rec
    local = recovery.RecoveredState(
        embed_rows=held, table_name=leaf, table_shape=tuple(held.shape),
        dense=dense, mirror_step=mirror_step, dense_step=dense_step,
        rolled_back=bool(rolled),
        gap=mirror_step - dense_step if dense_step >= 0 else -1)
    state, start = recovery.resume_train_state(local, init_state)
    return state, start, None
