"""Relaxed embedding lookup (counterpart of ``repro.core.relaxed``).

The RAW hazard: batch N's embedding update and batch N+1's lookup touch the
same rows. The relaxed schedule uses the commutativity of the additive row
update,

    gather(T + U, idx) == gather(T, idx) + gather(U, idx)  (exact; LMs)
    bag(T + U, idx)    == bag(T, idx) + bag(U, idx)        (linear; DLRM)

so batch N+1's rows are read from the pre-update table T, and the
correction ``gather(U, idx)`` (``bag(U, idx)``) is added once batch N's
delta U exists. "Rows" are the lookup's outputs: a DLRM's reduced bag
vectors (B, T, d), an LM's token rows (B, S, d). For an LM the correction
is added with the in-table update's arithmetic, so relaxed equals strict
bit for bit; for DLRM the bag sums run in another order.

Unlike the JAX package, the port never builds a table-sized gradient or
update: the adjoint of the lookup is kept at the touched rows only
(``sparse_rows_grad``), and the table is updated in place at those rows.
In-place means that the stale rows of batch N+1 must be read before the
update runs on the same stream; ``training.train_loop`` orders it so.

Every arch type is trained: DLRM, the transformer LMs (dense and MoE),
qwen2-vl, jamba, RWKV-6 (its wkv6 through its backward kernel,
``kernels.wkv6.WKV6``) and whisper. Whisper's head is tied to the token
table, so its table gradient, and its update U, cover every row: the
trainer then updates every row, and the correction reads U's rows straight
from the dense update (``prefetch_corrected`` with no scratch).
"""
from __future__ import annotations

from repro_torch.core import embedding_ops
from repro_torch.kernels import ops

TRAINED = ("dlrm", "transformer", "qwen2vl", "rwkv6", "jamba", "whisper")


def check_trainable(cfg) -> None:
    if cfg.arch_type not in TRAINED:
        raise NotImplementedError(
            f"the port trains {TRAINED} so far, not {cfg.arch_type!r}")


def embed_leaf(cfg) -> str:
    """The embedding tier's one leaf: DLRM's stacked tables, or an LM's
    token table (the reference's checkpoint manager names them so too)."""
    return "emb_tables" if cfg.arch_type == "dlrm" else "table"


def lookup_rows(embed_params: dict, cfg, batch: dict):
    """Pool lookup for a batch: bag vectors (B, T, d) for DLRM, token rows
    (B, S, d) for an LM, in the table's dtype."""
    check_trainable(cfg)
    if cfg.arch_type == "dlrm":
        return embedding_ops.bag_lookup(embed_params["emb_tables"],
                                        batch["sparse"])
    return embedding_ops.lookup(embed_params["table"], batch["tokens"])


def sparse_rows_grad(embed_params: dict, cfg, batch: dict, rows_grad):
    """Adjoint of ``lookup_rows`` at the touched rows only.

    Every row in a bag receives the bag's gradient; an LM's token row its
    own. Returns ``(uniq, grad)``: flat row ids into the table (DLRM: the
    (T*R, d) stacked tables) with -1 pads, and their (N, d) f32 gradients,
    duplicates summed in item order. The JAX package's
    ``scatter_rows_grad`` is the same gradient, dense.
    """
    check_trainable(cfg)
    table = embed_params[embed_leaf(cfg)]
    g = rows_grad.reshape(-1, table.shape[-1]).contiguous()
    if cfg.arch_type == "dlrm":
        flat, seg = embedding_ops.bag_items(batch["sparse"], table.shape[1])
        return ops.combine_duplicates(flat, g, item_rows=seg)
    flat = batch["tokens"].reshape(-1).to(g.device).int()
    return ops.combine_duplicates(flat, g)


def apply_embed_update(embed_params: dict, cfg, uniq, upd) -> None:
    """T = round(T + U) in place at the rows ``uniq`` (U given as rows)."""
    t = embed_params[embed_leaf(cfg)]
    ops.scatter_update(t.view(-1, t.shape[-1]), uniq, upd)


def apply_embed_update_logged(embed_params: dict, cfg, uniq, upd):
    """``apply_embed_update`` fused with undo capture (paper Fig. 7).

    Returns the rows ``uniq`` as they were before the update: (N, d) in the
    table's dtype, bitwise, +0 in the pad slots.
    """
    t = embed_params[embed_leaf(cfg)]
    return ops.scatter_update_logged(t.view(-1, t.shape[-1]), uniq, upd)[1]


def prefetch_corrected(stale, scratch, uniq, upd, cfg, next_batch: dict):
    """Relaxed prefetch of batch N+1's rows: round(f32(stale) + f32(corr)).

    ``stale`` is ``lookup_rows`` of batch N+1 on the PRE-update table, and
    corr the same lookup in U. ``scratch`` is an all-zero f32 tensor of the
    table's shape; U's rows are written into it, the correction is read
    from it (an LM row that U does not touch reads an exact +0), and the
    same rows are cleared again (u + (-u) is exactly +0), so it is all zero
    again on return. With ``scratch`` None, U covers every row of the
    table in order (``upd`` is (V, d), a tied head's update) and the
    correction is read from it directly. The add mirrors the in-table
    update's arithmetic, so for an LM the result is bitwise the lookup in
    the updated table; for DLRM it equals it up to the order of the f32
    sums.
    """
    check_trainable(cfg)
    if scratch is None:
        corr = lookup_rows({embed_leaf(cfg): upd}, cfg, next_batch)
        return (stale.float() + corr).to(stale.dtype)
    flat = scratch.view(-1, scratch.shape[-1])
    ops.scatter_update(flat, uniq, upd)
    corr = lookup_rows({embed_leaf(cfg): scratch}, cfg, next_batch)
    ops.scatter_update(flat, uniq, -upd)
    return (stale.float() + corr).to(stale.dtype)


def touched_indices(cfg, batch: dict):
    """The rows a batch WILL update, known from its ids before any compute
    (paper Fig. 6): DLRM's sparse features, an LM's tokens."""
    check_trainable(cfg)
    return batch["sparse"] if cfg.arch_type == "dlrm" else batch["tokens"]
