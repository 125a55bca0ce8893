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

Under a sharding context (DLRM and the decoders of arch type
transformer, dense or MoE, and jamba, under dense TP, Megatron-SP and
FSDP; the other LMs raise, ROADMAP queue 1 item 10(c))
each rank holds its block of every
table's rows over the ``table_rows`` axes (an LM: its block of the token
table over ``vocab``), or the whole tables where nothing shards them, and
its slice of the batch over the ``batch`` axes (``sharding.shard_batch``).
The lookups then run near the data on the rank's block (``rows=`` the
global row count), and the scratch is the block's size. The adjoint is
the one-rank adjoint restricted to the block: the bag rows' gradients and
the batch's ids are gathered over the data-parallel axes in rank order,
which is batch order, scaled by 1/dp (each rank's loss is the mean over
its own slice), and each rank combines the items of the global batch that
fall in its block (``embedding_ops.local_bag_items``), in item order, so
its ``(uniq, grad)`` are bitwise the one-rank combine's at its rows for
the same gradients. ``uniq`` are block-local flat ids into the held (T *
R_held, d) tables, as on one rank; the mesh checkpoint's writer maps them
into the (T * R, d) stacked tables, the checkpoint's layout. An LM's
adjoint follows the same pattern: the token ids and the rows' gradients
(whole on every rank of the TP axis, ``tensor_parallel.shard_stream``'s
backward) gathered over the data-parallel axes, each rank combining the
tokens in its vocab block, its ids block-local; the correction's scratch
is the block's.
"""
from __future__ import annotations

import torch

from repro_torch.core import embedding_ops
from repro_torch.distributed import sharding, tensor_parallel
from repro_torch.kernels import ops

TRAINED = ("dlrm", "transformer", "qwen2vl", "rwkv6", "jamba", "whisper")


def check_trainable(cfg) -> None:
    if cfg.arch_type not in TRAINED:
        raise NotImplementedError(
            f"the port trains {TRAINED} so far, not {cfg.arch_type!r}")
    ctx = sharding.current()
    if ctx is None or cfg.arch_type == "dlrm":
        return
    if not tensor_parallel.mesh_decoder(cfg):
        raise NotImplementedError(
            f"{cfg.name}: under a sharding context the port trains DLRM and the "
            f"decoders of arch type transformer (dense or MoE) and jamba; "
            f"{cfg.arch_type} under a mesh is ROADMAP queue 1 item 10(c)")
    if "moe" in cfg.ffn_types and ctx.mesh.axis_size("model") > 1 and ctx.tp != "model":
        raise NotImplementedError(
            f"{cfg.name}: the MoE blocks train expert-parallel over model under a "
            "heads rule over it (the reference's rules, launch.dryrun.build_rules), "
            f"which these rules lack ({ctx.rules.get('heads')!r})")
    tensor_parallel.check_supported(cfg)


def _rows(cfg) -> int:
    """The global row count of the embedding leaf: a DLRM table's rows, or
    an LM's vocabulary."""
    return cfg.dlrm_rows_per_table if cfg.arch_type == "dlrm" else cfg.vocab_size


def block(cfg, table) -> tuple:
    """Which rows of each DLRM table ``table`` (T, R_held, d) holds (an
    LM's token table (V_held, d): which of the vocabulary's):
    ``(R, base, psum)``, the global rows a table, the global row of the
    block's first, and the sum over the ranks that hold the other blocks
    (None where this rank holds the tables whole: no context, or no
    ``table_rows`` (``vocab``) axis, or one that does not divide R)."""
    dlrm = cfg.arch_type == "dlrm"
    R, held = _rows(cfg), table.shape[1 if dlrm else 0]
    ctx = sharding.current()
    if ctx is None:
        return held, 0, None
    mesh, tp_ax = ctx.mesh, ctx.axes("table_rows" if dlrm else "vocab")
    tp = embedding_ops._axis_size(mesh, tp_ax)
    if not embedding_ops._held(held, R, tp, "the trainer's tables"):
        return R, 0, None
    return R, mesh.axis_index(tp_ax) * held, (lambda x: mesh.all_reduce(x, tp_ax))


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
                                        batch["sparse"], rows=_rows(cfg))
    return embedding_ops.lookup(embed_params["table"], batch["tokens"],
                                rows=_rows(cfg))


def sparse_rows_grad(embed_params: dict, cfg, batch: dict, rows_grad):
    """Adjoint of ``lookup_rows`` at the touched rows only.

    Every row in a bag receives the bag's gradient; an LM's token row its
    own. Returns ``(uniq, grad)``: flat row ids into the table (DLRM: the
    (T*R, d) stacked tables) with -1 pads, and their (N, d) f32 gradients,
    duplicates summed in item order. The JAX package's
    ``scatter_rows_grad`` is the same gradient, dense.

    Under a sharding context: the gradient at the rows of the rank's
    block, from the global batch (the module's docstring), as block-local
    flat ids, padded to the global batch's item count (B * T * L, or an
    LM's B * S), the one-rank adjoint's length, so that every rank's feed
    has one length.
    """
    check_trainable(cfg)
    table = embed_params[embed_leaf(cfg)]
    if sharding.current() is not None:
        ids = batch["sparse"] if cfg.arch_type == "dlrm" else batch["tokens"]
        return _sparse_rows_grad_mesh(table, cfg, ids, rows_grad)
    g = rows_grad.reshape(-1, table.shape[-1]).contiguous()
    if cfg.arch_type == "dlrm":
        flat, seg = embedding_ops.bag_items(batch["sparse"], table.shape[1])
        return ops.combine_duplicates(flat, g, item_rows=seg)
    flat = batch["tokens"].reshape(-1).to(g.device).int()
    return ops.combine_duplicates(flat, g)


def _sparse_rows_grad_mesh(table, cfg, ids, rows_grad):
    ctx = sharding.current()
    mesh, dp_ax = ctx.mesh, ctx.axes("batch")
    dp = mesh.axis_size(dp_ax)
    g = rows_grad
    if dp > 1:
        ids = mesh.all_gather(ids, dp_ax, 0)
        g = mesh.all_gather(rows_grad, dp_ax, 0) * (1.0 / dp)
    d = table.shape[-1]
    _, base, _ = block(cfg, table)
    if cfg.arch_type == "dlrm":
        R_held = table.shape[1]
        flat, seg = embedding_ops.local_bag_items(ids, base, R_held, R_held, 0)
    else:        # the tokens in the rank's vocab block, in item order
        local = ids.reshape(-1).to(torch.int32) - base
        keep = (local >= 0) & (local < table.shape[0])
        flat = local[keep].contiguous()
        seg = torch.nonzero(keep).squeeze(1).to(torch.int32)
    uniq, comb = ops.combine_duplicates(flat, g.reshape(-1, d).contiguous(),
                                        item_rows=seg)
    pad = ids.numel() - uniq.shape[0]
    if pad:
        uniq = torch.cat([uniq, uniq.new_full((pad,), -1)])
        comb = torch.cat([comb, comb.new_zeros((pad, d))])
    return uniq, comb


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
    table's shape (under a context, of the rank's block: ``uniq`` is
    block-local and the correction bag runs near the data); U's rows are
    written into it, the correction is read from it (an LM row that U does
    not touch reads an exact +0), and the
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
