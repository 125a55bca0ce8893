"""Near-data embedding operations (counterpart of
``repro.core.embedding_ops``).

The paper's CXL-MEM computing logic in distributed form: under a sharding
context the tables are row-sharded over the mesh (``vocab`` for an LM's
token table, ``table_rows`` for DLRM's tables) and a lookup runs *next to
the data*: each rank gathers (for bags: and reduces) the rows it holds, on
the port's kernels, and only the reduced ``(batch, dim)`` vectors cross
the link, summed by ``all_reduce``. Raw rows never move.

Strategies (``lookup_mode``, thread-local; ``auto`` by default):
  * ``near_data``    : each rank's kernel over its own rows, partial
                       results summed across ranks. Link bytes: tokens x d
                       (bags: B x T x d, whatever L is).
  * ``table_gather`` : the table all-gathered whole, then a local lookup.
                       Link bytes: vocab_local x d x (tp - 1).
  * ``auto``         : the reference's ``_pick`` by the two byte counts;
                       ``table_gather`` at tp == 1, and where the rows (or
                       the batch) do not divide the mesh.
  * ``pool``         : the lookup reads an attached pool mirror
                       (``repro_torch.pool.EmbeddingPoolMirror``, or the
                       serving tier ``repro_torch.serve.EmbeddingServeTier``)
                       on the host: the ids come to the host, the mirror
                       gathers (bags: and reduces) near the data, and the
                       f32 rows go to the table's device in its dtype.
                       Forward only (serving, evaluation): the route raises
                       where autograd would record it. Updates go pool-side
                       through ``mirror.apply_grad``.

Outside a context (and under ``pool``'s) every mode but ``pool`` is the
kernel over the whole table: the row-gather kernel for a row lookup, the
embedding-bag kernel for a bag lookup.

A rank holds a sharded table as its block of rows (``distributed.sharding.
local_shard``: rank i of n the rows ``i * R/n .. (i + 1) * R/n - 1``); the
caller passes ``rows``, the global row count, so the island can tell a
rank's block from a whole table (which it also takes: each rank then reads
its own block of it).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed import sharding
from repro_torch.kernels import ops

_state = threading.local()
_pool_mirror = None   # module-global pool mirror (host-side object)


def attach_pool(mirror):
    """Install the pool mirror that backs the ``pool`` lookup strategy."""
    global _pool_mirror
    _pool_mirror = mirror


def detach_pool():
    global _pool_mirror
    _pool_mirror = None


def pool_mirror():
    return _pool_mirror


@contextlib.contextmanager
def lookup_mode(mode: str):
    prev = getattr(_state, "mode", "auto")
    _state.mode = mode
    try:
        yield
    finally:
        _state.mode = prev


def current_mode() -> str:
    return getattr(_state, "mode", "auto")


def _pool_route(table, ids, read, op: str):
    """``read(host ids)`` -> f32 numpy rows, on the table's device and in
    its dtype. One host round trip: the ids come to the host (a sync on the
    card), the rows go back."""
    if _pool_mirror is None:
        raise RuntimeError(f"{op}(mode='pool') needs attach_pool(...)")
    if torch.is_grad_enabled() and table.requires_grad:
        raise RuntimeError(f"{op}(mode='pool') has no gradient: the pool "
                           "route reads the mirror on the host; run it under "
                           "torch.no_grad() or with a table that needs none")
    rows = np.ascontiguousarray(read(ids.detach().cpu().numpy()), np.float32)
    return torch.from_numpy(rows).to(table.device).to(table.dtype)


def _axis_size(mesh, ax) -> int:
    """The ranks along the rule's axes; names not in the mesh count 1 (the
    reference raises on them)."""
    return mesh.axis_size(sharding._in_mesh(ax, set(mesh.axis_names)))


def _pick(mode: str, tokens: int, vocab: int, tp: int) -> str:
    if mode != "auto":
        return mode
    if tp == 1:
        return "table_gather"
    # near_data link bytes ~ tokens*d ; table_gather ~ vocab/tp*d*(tp-1)
    return "near_data" if tokens < vocab * (tp - 1) // tp else "table_gather"


def _held(n_held: int, n: int, tp: int, what: str) -> bool:
    """Whether a rank holding ``n_held`` rows of ``n`` holds its block
    (True) or the whole table (False)."""
    if n_held == n:
        return False
    if tp > 1 and n % tp == 0 and n_held * tp == n:
        return True
    raise ValueError(f"{what}: the rank holds {n_held} rows of {n}, neither the "
                     f"whole table nor its block over {tp} ranks")


def _kernel_rows(table, ids):
    if table.shape[0] >= 2**31:
        raise ValueError(f"{table.shape[0]} rows overflow int32 indices")
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    return ops.gather_rows(table, flat).reshape(*ids.shape, table.shape[-1])


def lookup(table, ids, *, mode: Optional[str] = None, rows: Optional[int] = None):
    """Row lookup, bitwise ``table[ids]``: through the row-gather kernel,
    near the data under a sharding context, or in mode ``pool`` from the
    attached mirror (rows held in f32, so a bf16 or f16 table's rows come
    back bit for bit).

    table: (V, d) contiguous, or under a context this rank's block of
    ``rows`` (the global V; default: ``table`` is whole); ids: int tensor
    of values in [0, V) on the table's device -> ids.shape + (d,) in the
    table's dtype. The ``near_data`` partial rows are summed in f32, so a
    row plus zeros comes back exactly.
    """
    mode = mode or current_mode()
    if mode == "pool":
        mir = _pool_mirror
        return _pool_route(table, ids, lambda i: mir.lookup(i), "lookup") \
            .reshape(*ids.shape, table.shape[-1])
    ctx = sharding.current()
    if ctx is None:
        return _kernel_rows(table, ids)
    mesh = ctx.mesh
    V = rows or table.shape[0]
    tp_ax = ctx.axes("vocab")
    tp = _axis_size(mesh, tp_ax)
    blocked = _held(table.shape[0], V, tp, "lookup")
    strat = _pick(mode, ids.numel(), V, tp)
    dp_ax = ctx.axes("batch")
    if V % tp or (dp_ax and ids.shape[0] % _axis_size(mesh, dp_ax)):
        strat = "table_gather"   # pool rows (or batch) don't divide the mesh
    if strat == "table_gather" or tp == 1:
        whole = mesh.all_gather(table, tp_ax, 0) if blocked else table
        return _kernel_rows(whole, ids)

    rows_local = V // tp
    base = mesh.axis_index(tp_ax) * rows_local
    mine = table if blocked else table[base:base + rows_local]
    idx = ids.long() - base
    valid = (idx >= 0) & (idx < rows_local)
    got = _kernel_rows(mine, idx.clamp(0, rows_local - 1))
    part = torch.where(valid[..., None], got.float(), 0.0)
    return mesh.all_reduce(part, tp_ax).to(table.dtype)


def bag_items(ids, rows_per_table: int):
    """Flatten a (B, T, L) id tensor into the bag kernel's item lists.

    Returns ``(flat, seg)``, both (B*T*L,) int32: item (b, t, l) reads row
    ``t * rows_per_table + ids[b, t, l]`` of the stacked (T*R, d) tables and
    belongs to bag ``b * T + t``.
    """
    B, T, L = ids.shape
    if T * rows_per_table >= 2**31:
        raise ValueError(f"{T} x {rows_per_table} rows overflow int32 indices")
    offs = torch.arange(T, dtype=torch.int32, device=ids.device) * rows_per_table
    flat = (ids.to(torch.int32) + offs[None, :, None]).reshape(-1)
    seg = torch.arange(B * T, dtype=torch.int32,
                       device=ids.device).repeat_interleave(L)
    return flat, seg


def _bag_kernel(tables, ids, combine: str):
    T, R, d = tables.shape
    B, L = ids.shape[0], ids.shape[-1]
    flat, seg = bag_items(ids, R)
    out = ops.embedding_bag(tables.reshape(T * R, d), flat, seg, B * T).view(B, T, d)
    return (out / L if combine == "mean" else out).to(tables.dtype)


def local_bag_items(ids, base: int, rows_local: int, held_rows: int, held_base: int):
    """The items of a (B, T, L) id tensor whose row falls in ``[base, base +
    rows_local)``, in item order (so ``seg`` stays non-decreasing and a bag
    with none of them reads 0): ``(flat, seg)`` into the held (T *
    held_rows, d) tables, in which the block starts at row ``held_base``."""
    flat, seg = bag_items(ids - base + held_base, held_rows)
    local = (ids - base).reshape(-1)
    keep = (local >= 0) & (local < rows_local)
    return flat[keep], seg[keep]


def bag_lookup(tables, ids, *, mode: Optional[str] = None, combine: str = "sum",
               rows: Optional[int] = None):
    """DLRM multi-table bag lookup.

    tables: (T, R, d) stacked embedding tables, or under a context this
    rank's block of ``rows`` rows a table (the global R; default: whole);
    ids: (B, T, L) row indices. Returns (B, T, d) in the tables' dtype, each
    bag's L rows reduced by ``combine`` ("sum" or "mean"): summed in f32 by
    the bag kernel; ``near_data``: each rank's kernel over only the items
    in its rows, the partial bags (B, T, d) in f32 summed by ``all_reduce``
    (the CXL-MEM adder array: the link carries B*T*d whatever L is); in
    mode ``pool`` near the data by the attached mirror. The mirror must
    hold the tables as (T, R, d), so that it adds each table's row offset;
    a flat (T*R, d) mirror (the checkpoint manager's) raises, where the JAX
    package would read table 0's rows for every table.
    """
    if combine not in ("sum", "mean"):
        raise ValueError(f"bag_lookup: combine {combine!r} (sum or mean)")
    T, R_held, d = tables.shape
    B, L = ids.shape[0], ids.shape[-1]
    mode = mode or current_mode()
    if mode == "pool":
        mir = _pool_mirror
        if mir is not None and tuple(mir.shape) != (T, R_held, d):
            raise ValueError(
                f"bag_lookup(mode='pool'): the mirror holds {tuple(mir.shape)}, "
                f"not the tables' {(T, R_held, d)}; a flat mirror has no per-table "
                "row offsets")
        return _pool_route(tables, ids, lambda i: mir.bag_lookup(i, combine),
                           "bag_lookup").reshape(B, T, d)
    ctx = sharding.current()
    if ctx is None:
        return _bag_kernel(tables, ids, combine)
    mesh = ctx.mesh
    R = rows or R_held
    tp_ax = ctx.axes("table_rows")
    tp = _axis_size(mesh, tp_ax)
    blocked = _held(R_held, R, tp, "bag_lookup")
    if tp == 1 or mode == "table_gather":
        whole = mesh.all_gather(tables, tp_ax, 1) if blocked else tables
        return _bag_kernel(whole, ids, combine)

    rows_local = R // tp
    base = mesh.axis_index(tp_ax) * rows_local
    flat, seg = local_bag_items(ids, base, rows_local, R_held, 0 if blocked else base)
    part = ops.embedding_bag(tables.reshape(T * R_held, d), flat, seg, B * T)
    out = mesh.all_reduce(part, tp_ax).view(B, T, d)
    return (out / L if combine == "mean" else out).to(tables.dtype)
