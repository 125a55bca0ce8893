"""FSDP: the dense decoder's weights held in blocks over ``data`` as well as
``model``, and gathered at their use (port-only: the reference gets ZeRO-3
from XLA, which places each weight by ``param_specs`` under the weight rule
``w_embed: "data"``, ``src/repro/launch/dryrun.py:104-108``, and gathers
it where a dot needs it).

A rank holds each of the dense decoder's projections and its head
(``sharding.TP_LEAVES``) by the reference's spec, downgraded where the mesh
does not divide it (``sharding.held_spec``): under an fsdp profile at
(data, model) = (2, 2) a quarter of each, ``wq|wk|wv|wi|wg`` and
``lm_head`` as (data, model) blocks, both ``wo`` as (model, data) blocks.
A layer computes with the leaf in its *compute layout*: the leaf's
``model`` block, whole over ``data`` (``wq``, ``wo``, ``wi``, ``wg``, the
MLP's ``wo`` and ``lm_head``: the column, row and vocab blocks of dense
tensor parallelism), or whole where a rank runs every kv head it reads
itself: ``wk``/``wv`` where ``model`` does not divide the kv heads
(``tensor_parallel.kv_replicated``), of which the rank then projects the
kv heads its own query heads read (``tensor_parallel.kv_cols``).

``mm(x, w, cfg, path)`` is ``x @ W`` with W the held leaf ``w`` in its
compute layout: one ``torch.autograd.Function`` that all-gathers ``w``
over the axes that its held spec names and its compute layout does not
(``Mesh.all_gather_blocks``, one sum over those axes), multiplies, and
frees the gathered weight. It saves ``x`` and the held block, never the
gathered weight: the backward gathers again, forms ``x^T g`` and
reduce-scatters it to the held block (``Mesh.reduce_scatter_blocks``), a
sum over ``data`` (the data-parallel ranks' batches: the trainer then
divides by their number and sums no more, ``train_loop.sync_dense_``) and,
for a replicated ``wk``/``wv``, over ``model`` too (the partial sums of the
ranks' query heads). So a rank holds at most one projection's weight whole
at a time, in the forward, in the backward, and in a remat recompute. Every
rank issues the same collectives in the same order: the layers call ``mm``
in one order on every rank and autograd walks one graph.

Without a context, or under one whose rules name neither ``heads`` nor
``w_embed``, ``mm`` is ``x @ w``; so it is where the compute layout is
the held one (dense tensor parallelism alone, the kv heads split).
"""
from __future__ import annotations

import re

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp

_LEAF = re.compile(r"(attn/(?:wq|wk|wv|wo)|mlp/(?:wi|wg|wo)|lm_head)$")
_KV = re.compile(r"attn/(wk|wv)$")


def whole_shape(cfg, path: str, ndim: int) -> tuple:
    """The whole shape of the dense leaf at ``path`` (a projection or the
    head; ``ndim`` 3: stacked over the layers, or 2: one layer's)."""
    m = _LEAF.search(path)
    if m is None:
        raise ValueError(f"{path}: not a projection or the head")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv, ff = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff
    two = {"attn/wq": (d, q), "attn/wk": (d, kv), "attn/wv": (d, kv), "attn/wo": (q, d),
           "mlp/wi": (d, ff), "mlp/wg": (d, ff), "mlp/wo": (ff, d),
           "lm_head": (d, cfg.vocab_size)}[m.group(1)]
    return two if ndim == 2 else (cfg.num_layers, *two)


def held_dims(cfg, path: str, ndim: int) -> dict:
    """{dim: mesh axis} over which the current context's rank holds a block
    of the leaf at ``path`` (a dense param, or an optimizer moment of
    one), the axes of one rank left out; {} for a leaf held whole."""
    ctx = sharding.current()
    if (ctx is None or not sharding.is_tp_leaf(path)
            or not sharding.blocks_dense(ctx.rules, ctx.mesh_axes)):
        return {}
    spec = sharding.held_spec(path, whole_shape(cfg, path, ndim), ctx.mesh, ctx.rules)
    return {i: ax for i, ax in enumerate(spec)
            if ax is not None and ctx.mesh.axis_size(ax) > 1}


def gathered_dims(cfg, path: str, ndim: int) -> dict:
    """The held dims that the leaf's compute layout has whole: every one
    but the TP axis's, and that too for a replicated ``wk``/``wv``."""
    ctx = sharding.current()
    keep = ctx.tp if ctx is not None and not (
        tp.kv_replicated(cfg) and _KV.search(path)) else None
    return {d: ax for d, ax in held_dims(cfg, path, ndim).items() if ax != keep}


def _compute(w, mesh, dims, cols):
    whole = mesh.all_gather_blocks(w, dims) if dims else w
    return whole if cols is None else whole[:, cols]


class _Project(torch.autograd.Function):
    """``x @ W``, W the held block ``w`` gathered over ``dims`` (and cut to
    the columns ``cols``); the backward gathers W again and reduce-scatters
    the weight's gradient to the held block."""

    @staticmethod
    def forward(ctx, x, w, mesh, dims, cols):
        ctx.mesh, ctx.dims, ctx.cols = mesh, dims, cols
        ctx.save_for_backward(x, w)
        return x @ _compute(w, mesh, dims, cols)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mesh, dims, cols = ctx.mesh, ctx.dims, ctx.cols
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = g @ _compute(w, mesh, dims, cols).T
        if ctx.needs_input_grad[1]:
            gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
            if cols is not None:
                full = gw.new_zeros(_compute_shape(w, mesh, dims))
                full[:, cols] = gw
                gw = full
            gw = mesh.reduce_scatter_blocks(gw, dims) if dims else gw
        return gx, gw, None, None, None


def _compute_shape(w, mesh, dims) -> list:
    shape = list(w.shape)
    for d, ax in dims.items():
        shape[d] *= mesh.sizes[ax]
    return shape


def mm(x, w, cfg, path: str):
    """``x @ W`` for the held leaf ``w`` of one layer at ``path`` (``attn/wq``
    ... ``lm_head``), W its compute layout (the module's docstring); the
    plain ``x @ w`` where that layout is the held leaf itself."""
    ctx = sharding.current()
    if ctx is None or not sharding.blocks_dense(ctx.rules, ctx.mesh_axes):
        return x @ w
    dims = gathered_dims(cfg, path, w.dim())
    cols = tp.kv_cols(cfg) if _KV.search(path) else None
    if not dims and cols is None:
        return x @ w
    if cols is not None and ctx.tp not in dims.values():
        raise NotImplementedError(
            f"{cfg.name}: {path} whole on every model rank with the kv heads "
            "replicated, which would leave its gradient a partial sum over model")
    return _Project.apply(x, w, ctx.mesh, dims, cols)


def matmul(cfg, path: str):
    """``mm`` for the leaf at ``path`` as a callable ``(x, w)``, under the
    sharding context in force now: a checkpointed chunk's recompute runs
    it again where autograd runs the backward, on a card a thread of its
    own that has no context."""
    ctx = sharding.current()

    def f(x, w):
        with sharding.restore(ctx):
            return mm(x, w, cfg, path)
    return f
