"""Embedding lookups (counterpart of ``repro.core.embedding_ops``, unsharded).

Two strategies:
  * the kernels (any mode but ``pool``): the bag lookup runs through the
    embedding-bag kernel on the card, the row lookup (an LM's token
    embedding) through the row-gather kernel;
  * ``pool``: the lookup reads an attached pool mirror
    (``repro_torch.pool.EmbeddingPoolMirror``, or the serving tier
    ``repro_torch.serve.EmbeddingServeTier``) on the host. The ids come to
    the host, the mirror gathers (bag lookups: and reduces) near the data,
    and the f32 rows go to the table's device and its dtype. Forward only
    (serving, evaluation): the route raises where autograd would record
    it, since no gradient reaches the table through it. Updates go
    pool-side through ``mirror.apply_grad``.

``attach_pool`` installs the mirror, ``lookup_mode("pool")`` (thread-local)
selects the route. The JAX package's sharded strategies (``near_data``,
``table_gather``, ``auto``) are not ported.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

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


def lookup(table, ids, *, mode: Optional[str] = None):
    """Row lookup, bitwise ``table[ids]``: through the row-gather kernel,
    or in mode ``pool`` from the attached mirror (rows held in f32, so a
    bf16 or f16 table's rows come back bit for bit).

    table: (V, d) contiguous; ids: int tensor of values in [0, V) on the
    table's device -> ids.shape + (d,) in the table's dtype.
    """
    if (mode or current_mode()) == "pool":
        mir = _pool_mirror
        return _pool_route(table, ids, lambda i: mir.lookup(i), "lookup") \
            .reshape(*ids.shape, table.shape[-1])
    if table.shape[0] >= 2**31:
        raise ValueError(f"{table.shape[0]} rows overflow int32 indices")
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    return ops.gather_rows(table, flat).reshape(*ids.shape, table.shape[-1])


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


def bag_lookup(tables, ids, *, mode: Optional[str] = None):
    """DLRM multi-table bag lookup (sum combiner).

    tables: (T, R, d) stacked embedding tables; ids: (B, T, L) row indices.
    Returns (B, T, d) in the tables' dtype; the bags are summed in f32,
    by the bag kernel, or in mode ``pool`` near the data by the attached
    mirror. The mirror must hold the tables as (T, R, d), so that it adds
    each table's row offset; a flat (T*R, d) mirror (the checkpoint
    manager's) raises, where the JAX package would read table 0's rows
    for every table.
    """
    T, R, d = tables.shape
    B = ids.shape[0]
    if (mode or current_mode()) == "pool":
        mir = _pool_mirror
        if mir is not None and tuple(mir.shape) != (T, R, d):
            raise ValueError(
                f"bag_lookup(mode='pool'): the mirror holds {tuple(mir.shape)}, "
                f"not the tables' {(T, R, d)}; a flat mirror has no per-table "
                "row offsets")
        return _pool_route(tables, ids, lambda i: mir.bag_lookup(i, "sum"),
                           "bag_lookup").reshape(B, T, d)
    flat, seg = bag_items(ids, R)
    out = ops.embedding_bag(tables.view(T * R, d), flat, seg, B * T)
    return out.view(B, T, d).to(tables.dtype)
