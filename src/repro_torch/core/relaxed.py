"""Relaxed embedding lookup (counterpart of ``repro.core.relaxed``, DLRM).

The RAW hazard: batch N's embedding update and batch N+1's lookup touch the
same rows. The relaxed schedule uses the commutativity of the additive row
update,

    bag(T + U, idx) == bag(T, idx) + bag(U, idx)          (linear)

so batch N+1's bags are read from the pre-update table T, and the
correction ``bag(U, idx)`` is added once batch N's delta U exists.

Unlike the JAX package, the port never builds a table-sized gradient or
update: the adjoint of the lookup is kept at the touched rows only
(``sparse_rows_grad``), and the tables are updated in place at those rows.
In-place means that the stale bag of batch N+1 must be read before the
update runs on the same stream; ``training.train_loop`` orders it so.
"""
from __future__ import annotations

from repro_torch.core import embedding_ops
from repro_torch.kernels import ops


def _dlrm_only(cfg) -> None:
    if cfg.arch_type != "dlrm":
        raise NotImplementedError(
            f"the port runs DLRM only so far, not {cfg.arch_type!r}")


def lookup_rows(embed_params: dict, cfg, batch: dict):
    """Pool lookup for a batch -> reduced bag vectors (B, T, d)."""
    _dlrm_only(cfg)
    return embedding_ops.bag_lookup(embed_params["emb_tables"], batch["sparse"])


def sparse_rows_grad(embed_params: dict, cfg, batch: dict, rows_grad):
    """Adjoint of ``lookup_rows`` at the touched rows only.

    Every row in a bag receives the bag's gradient. Returns
    ``(uniq, grad)``: flat row ids into the (T*R, d) tables with -1 pads,
    and their (N, d) f32 gradients, duplicates summed in item order. The
    JAX package's ``scatter_rows_grad`` is the same gradient, dense.
    """
    _dlrm_only(cfg)
    tables = embed_params["emb_tables"]
    flat, seg = embedding_ops.bag_items(batch["sparse"], tables.shape[1])
    g = rows_grad.reshape(-1, tables.shape[-1]).contiguous()
    return ops.combine_duplicates(flat, g, item_rows=seg)


def apply_embed_update(embed_params: dict, uniq, upd) -> None:
    """T = round(T + U) in place at the rows ``uniq`` (U given as rows)."""
    t = embed_params["emb_tables"]
    ops.scatter_update(t.view(-1, t.shape[-1]), uniq, upd)


def prefetch_corrected(stale, scratch, uniq, upd, cfg, next_batch: dict):
    """Relaxed prefetch of batch N+1's bags: round(f32(stale) + bag(U, idx)).

    ``stale`` is ``lookup_rows`` of batch N+1 on the PRE-update tables.
    ``scratch`` is an all-zero f32 tensor of the tables' (T, R, d) shape; U's
    rows are written into it, the correction bag is read from it, and the
    same rows are cleared again (u + (-u) is exactly +0), so it is all zero
    again on return. Equal to looking batch N+1 up in the updated tables, up
    to the order of the f32 sums.
    """
    _dlrm_only(cfg)
    flat = scratch.view(-1, scratch.shape[-1])
    ops.scatter_update(flat, uniq, upd)
    corr = embedding_ops.bag_lookup(scratch, next_batch["sparse"])
    ops.scatter_update(flat, uniq, -upd)
    # mirror the in-table update arithmetic: f32 add, round to table dtype
    return (stale.float() + corr).to(stale.dtype)


def touched_indices(cfg, batch: dict):
    """The rows a batch WILL update, known from its sparse features before
    any compute (paper Fig. 6)."""
    _dlrm_only(cfg)
    return batch["sparse"]
