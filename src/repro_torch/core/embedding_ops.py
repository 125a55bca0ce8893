"""Embedding lookups (counterpart of ``repro.core.embedding_ops``, unsharded).

The bag lookup runs through the embedding-bag kernel on the card, the row
lookup (an LM's token embedding) through the row-gather kernel. The
``pool`` strategy and the sharded strategies of the JAX package are not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def lookup(table, ids):
    """Row lookup through the row-gather kernel, bitwise ``table[ids]``.

    table: (V, d) contiguous; ids: int tensor of values in [0, V) on the
    table's device -> ids.shape + (d,) in the table's dtype.
    """
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


def bag_lookup(tables, ids):
    """DLRM multi-table bag lookup (sum combiner).

    tables: (T, R, d) stacked embedding tables; ids: (B, T, L) row indices.
    Returns (B, T, d) in the tables' dtype; the bags are summed in f32.
    """
    T, R, d = tables.shape
    B = ids.shape[0]
    flat, seg = bag_items(ids, R)
    out = ops.embedding_bag(tables.view(T * R, d), flat, seg, B * T)
    return out.view(B, T, d).to(tables.dtype)
