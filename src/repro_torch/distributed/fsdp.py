"""FSDP: the decoders' weights held in blocks over ``data`` as well as
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

The MoE and mamba blocks add their leaves (the reference's specs,
``src/repro/distributed/sharding.py:94-110``): arctic's dense residual
(``moe/dense/*``) is held and computed as the MLP's leaves are; the
``router`` (d, E) as (data, None) blocks, gathered whole, its products in
full f32 with TF32 off (``f32``; its weight is f32: a rounded logit would
flip near ties in top-k); the experts (E, d, f) as (model, data, None) blocks, a rank
computing with its ``E / tp`` experts gathered whole over ``data`` in a
batched product; mamba's ``out_proj`` as the attention ``wo``, its
``bc_proj`` and ``dt_proj`` as (model, None) row blocks, computed as held;
and its ``in_proj`` (d, 2 di), whose columns are ``[xi | z]``: rank r
holds a column block of it, but computes with the channels of its SSD
heads in each half (``in_proj_cols``), so the leaf is gathered whole over
both axes, cut to those columns, and its gradient reduce-scattered over
both (each rank's columns are its own: the sum over ``model`` adds
zeros), as a replicated ``wk`` is.

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
``w_embed`` (but for the experts, held over ``experts`` under every
context), ``mm`` is ``x @ w``; so it is where the compute layout is the
held one (dense tensor parallelism alone, the kv heads split).
"""
from __future__ import annotations

import contextlib
import re

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp

_KV = re.compile(r"attn/(wk|wv)$")
_IN_PROJ = re.compile(r"mamba/in_proj$")
# the key of a dense leaf's path in ``_shapes``
_KEY = re.compile(r"((?:attn|mlp|moe/dense|moe|mamba)/\w+|lm_head)$")


def is_dense_leaf(path: str) -> bool:
    """A leaf that ``mm`` multiplies held: a TP leaf (a projection, the
    router, the head) or an expert stack."""
    return sharding.is_tp_leaf(path) or sharding.is_expert_leaf(path)


def _shapes(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv, ff = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff
    e, fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
    di, ds = cfg.mamba.d_inner(d), cfg.mamba.d_state
    return {"attn/wq": (d, q), "attn/wk": (d, kv), "attn/wv": (d, kv), "attn/wo": (q, d),
            "mlp/wi": (d, ff), "mlp/wg": (d, ff), "mlp/wo": (ff, d),
            "moe/dense/wi": (d, ff), "moe/dense/wg": (d, ff), "moe/dense/wo": (ff, d),
            "moe/router": (d, e), "moe/wi": (e, d, fe), "moe/wg": (e, d, fe),
            "moe/wo": (e, fe, d), "mamba/in_proj": (d, 2 * di), "mamba/out_proj": (di, d),
            "mamba/bc_proj": (di, 2 * ds), "mamba/dt_proj": (di, cfg.mamba.num_heads(d)),
            "lm_head": (d, cfg.vocab_size)}


def whole_shape(cfg, path: str, ndim: int) -> tuple:
    """The whole shape of the dense leaf at ``path`` (``is_dense_leaf``;
    ``ndim`` one more than one layer's where the leaf is stacked over the
    layers, or over jamba's groups of one period each)."""
    if not is_dense_leaf(path):
        raise ValueError(f"{path}: not a projection, the router, the experts or the head")
    one = _shapes(cfg)[_KEY.search(path).group(1)]
    if ndim == len(one):
        return one
    groups = path.startswith("groups/")
    return (cfg.num_layers // cfg.attn_layer_period if groups else cfg.num_layers, *one)


def held_dims(cfg, path: str, ndim: int) -> dict:
    """{dim: mesh axis} over which the current context's rank holds a block
    of the leaf at ``path`` (a dense param, or an optimizer moment of
    one), the axes of one rank left out; {} for a leaf held whole."""
    ctx = sharding.current()
    if ctx is None or not is_dense_leaf(path) or not (
            sharding.is_island_leaf(path)
            or sharding.blocks_dense(ctx.rules, ctx.mesh_axes)):
        return {}
    spec = sharding.held_spec(path, whole_shape(cfg, path, ndim), ctx.mesh, ctx.rules)
    return {i: ax for i, ax in enumerate(spec)
            if ax is not None and ctx.mesh.axis_size(ax) > 1}


def gathered_dims(cfg, path: str, ndim: int) -> dict:
    """The held dims that the leaf's compute layout has whole: every one
    but the TP axis's (the experts': the ``experts`` axis's, the same
    ``model``), and that too for a replicated ``wk``/``wv`` and for
    mamba's ``in_proj``, whose compute columns are no held block
    (``in_proj_cols``)."""
    ctx = sharding.current()
    keep = ctx.tp if ctx is not None and not (
        (tp.kv_replicated(cfg) and _KV.search(path)) or _IN_PROJ.search(path)) else None
    if ctx is not None and sharding.is_island_leaf(path):
        keep = ctx.axes("experts")
    return {d: ax for d, ax in held_dims(cfg, path, ndim).items() if ax != keep}


_HALF = (torch.bfloat16, torch.float16)


@contextlib.contextmanager
def _tf32(allow: bool):
    """TF32 products on the card allowed or not for the duration. A 16-bit
    operand widened to f32 is exact in TF32 (10 mantissa bits), and so is
    the gradient of a 16-bit output: their products on the tensor cores
    are the full-f32 ones (exact, summed in f32). A gradient summed over
    the ranks after that rounding (mamba's B, C and dt) is rounded to TF32,
    finer than the 16-bit rounding one rank makes there. A real f32
    operand (the router's weight, an f32 model) needs TF32 off."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _compute(w, mesh, dims, cols):
    whole = mesh.all_gather_blocks(w, dims) if dims else w
    return whole if cols is None else whole[:, cols]


class _Project(torch.autograd.Function):
    """``x @ W``, W the held block ``w`` gathered over ``dims`` (and cut to
    the columns ``cols``); the backward gathers W again and reduce-scatters
    the weight's gradient to the held block. A 3-D ``w`` (an expert stack,
    (E, d_in, d_out)) is a batched product with x (E, C, d_in). ``f32``:
    every product with an f32 output, the gradients rounded once to the
    operands' dtypes. The forward of 16-bit operands on the card is the
    tensor cores' 16-bit product with an f32 output (``_f32_out``); else,
    and in the backward, whose gradient is f32, the operands are widened
    (their products exact, their sums in f32; TF32 on where both operands
    are 16-bit, exact for them, else off)."""

    @staticmethod
    def forward(ctx, x, w, mesh, dims, cols, f32):
        ctx.mesh, ctx.dims, ctx.cols, ctx.f32 = mesh, dims, cols, f32
        ctx.save_for_backward(x, w)
        W = _compute(w, mesh, dims, cols)
        if not f32:
            return x @ W
        if x.is_cuda and x.dtype in _HALF and W.dtype == x.dtype:
            return _f32_out(x, W)
        with _tf32(False):
            return x.float() @ W.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mesh, dims, cols = ctx.mesh, ctx.dims, ctx.cols
        gx = gw = None
        wide = (lambda t: t.float()) if ctx.f32 else (lambda t: t)
        with _tf32(x.dtype in _HALF and w.dtype in _HALF) if ctx.f32 \
                else contextlib.nullcontext():
            if ctx.needs_input_grad[0]:
                gx = (g @ wide(_compute(w, mesh, dims, cols)).mT).to(x.dtype)
            if ctx.needs_input_grad[1]:
                if w.dim() == 3:
                    gw = wide(x).mT @ g
                else:
                    gw = wide(x).reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
                gw = gw.to(w.dtype)
        if gw is not None:
            if cols is not None:
                full = gw.new_zeros(_compute_shape(w, mesh, dims))
                full[:, cols] = gw
                gw = full
            gw = mesh.reduce_scatter_blocks(gw, dims) if dims else gw
        return gx, gw, None, None, None, None


def _f32_out(x, w):
    """``x @ w`` of 16-bit operands of one type on the card, an f32 output
    (``torch.mm``'s ``out_dtype``; ``w`` one matrix, or a stack with x
    (E, C, d_in))."""
    if w.dim() == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def f32_matmul(x, w):
    """``x @ w`` in f32 (``_Project``'s ``f32``: 16-bit operands widened),
    its backward's products too."""
    return _Project.apply(x, w, None, {}, None, True)


def _compute_shape(w, mesh, dims) -> list:
    shape = list(w.shape)
    for d, ax in dims.items():
        shape[d] *= mesh.sizes[ax]
    return shape


def in_proj_cols(cfg):
    """The columns of mamba's whole ``in_proj`` (d, 2 di), ``[xi | z]``,
    that this rank computes with under dense tensor parallelism: the
    channels of its ``nh / tp`` SSD heads in each half (an index tensor),
    else None."""
    n = tp.size()
    if n == 1:
        return None
    di = cfg.mamba.d_inner(cfg.d_model)
    step = di // n
    r = sharding.current().mesh.axis_index(tp.axis())
    mine = torch.arange(r * step, (r + 1) * step)
    return torch.cat([mine, di + mine])


def mm(x, w, cfg, path: str, f32: bool = False):
    """``x @ W`` for the held leaf ``w`` of one layer at ``path`` (``attn/wq``
    ... ``lm_head``, ``moe/router``, an expert stack ``moe/wi`` as a batched
    product), W its compute layout (the module's docstring); the plain
    ``x @ w`` where that layout is the held leaf itself. ``f32``: the
    product and its backward's in f32, an f32 output
    (``f32_matmul``)."""
    ctx = sharding.current()
    plain = f32_matmul if f32 else torch.matmul
    if ctx is None or not (sharding.blocks_dense(ctx.rules, ctx.mesh_axes)
                           or sharding.is_island_leaf(path)):
        return plain(x, w)
    dims = gathered_dims(cfg, path, w.dim())
    cols = tp.kv_cols(cfg) if _KV.search(path) else \
        in_proj_cols(cfg) if _IN_PROJ.search(path) else None
    if not dims and cols is None:
        return plain(x, w)
    if cols is not None and ctx.tp not in dims.values():
        raise NotImplementedError(
            f"{cfg.name}: {path} whole on every model rank with its compute "
            "columns cut, which would leave its gradient a partial sum over model")
    if cols is not None and not isinstance(cols, slice):
        cols = cols.to(w.device)
    return _Project.apply(x, w, ctx.mesh, dims, cols, f32)


def row_parallel(y, w, cfg, path: str):
    """A row-parallel projection closed over the TP axis, ``leave(y @ W)``
    (``mm``'s W): under tensor parallelism each rank's partial product in
    f32 (of 16-bit operands on the card, the tensor cores' product with an
    f32 output), summed over the ranks and rounded once to ``y``'s dtype,
    as one rank's product rounds once; else ``mm(y, w)``. The sum moves f32
    (under gloo on the card a 16-bit sum moves an f32 copy anyway,
    ``Mesh._reduce``), its gradient 16-bit."""
    if tp.size() == 1:
        return mm(y, w, cfg, path)
    return tp.leave(mm(y, w, cfg, path, f32=True), y.dtype)


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
