"""Training steps: strict (dependent) and relaxed (paper) schedules.

Counterpart of ``repro.training.train_loop`` for DLRM and the dense
transformer LMs, with ``torch.autograd`` in place of ``jax.value_and_grad``.

strict_step:
    lookup_N -> fwd/bwd_N -> update_dense -> update_pool
relaxed_step (TrainingCXL):
    fwd/bwd on the bags prefetched at step N-1, the stale lookup of batch
    N+1 on the pre-update tables, the pool update fused with undo capture
    (the pre-update rows it overwrites, paper Fig. 7), then the correction
    bag(U, idx_{N+1}) added to the stale bags. Its metrics carry
    ``ckpt_feed``: the touched row ids, their deltas and that undo image.

Both steps take the loss's gradient with respect to the looked-up rows (a
DLRM's bag vectors, an LM's token rows), spread it over the touched table
rows with duplicates combined in a fixed order, and update the table in
place at those rows only (``core.relaxed``). No table-sized gradient or
update is ever built. The embedding tier therefore takes the rules that
have a touched-rows form (``Optimizer.update_rows``): SGD and row-wise
Adagrad, whose accumulator is updated in place too. SGD with momentum
raises (its momentum moves untouched rows). The dense tier is the rest of
the tree (an LM's blocks, final norm and head) under ``train_cfg.optimizer``.

A head tied to the table (whisper) reads the whole table, so its gradient
with respect to the table is dense. Both steps then add the touched rows'
gradient into it (the rows' adjoint plus the head's, as the reference
sums them, ``src/repro/training/train_loop.py:93-97``) and update every
row of the table: the touched-rows machinery runs with every row touched,
ids 0 .. V-1. The relaxed correction reads U at batch N+1's tokens straight
from that dense update, with no scratch.

The table, the embedding optimizer's state, the dense params and the dense
optimizer's moments are all updated in place (the dense tier through ``update_inplace`` where the
optimizer has one, else its f32 updates added leaf by leaf), so a step
returns a state that shares them with the state it was given; a caller
that needs an earlier state clones it. At full width no second copy of
the dense tier or its moments is ever held.

Under a sharding context (``distributed.sharding.use_sharding``; DLRM and
the decoders of arch type transformer, dense or MoE, and jamba, the other
LMs raise) each rank is one process holding its part of the state: the
tables' rows over the ``table_rows`` axes (an LM's token table over
``vocab``), the experts over ``experts``, the dense tier and its moments
whole, or under a ``heads`` rule the decoders' column, row and vocab
blocks (``distributed.tensor_parallel``), under a ``w_embed`` rule
(FSDP) blocks over ``data`` as well (``distributed.fsdp``), the moments
laid out like their params, and its slice of every batch over the
``batch`` axes (``train`` splits each batch it draws with
``sharding.shard_batch``).
A step then computes what the reference's step jitted with its state and
batch shardings computes: the dense grads are summed over the
data-parallel axes and divided by their size before the clip (a
replicated leaf that saw only the rank's rows or heads is first summed
over the TP axis; a leaf held in blocks over ``data`` arrives summed by
its gather's backward and is only divided; the clip sums each leaf's
blocks' squares over the axes they lie over and counts a whole leaf
once), so the norm is the global gradient's, and the loss reported is
the mean over them; the sparse adjoint, its update and the relaxed correction run on
each rank's block (``core.relaxed``); a rule whose state spans a whole
table (row-wise Adagrad's DLRM accumulator) sums its per-table terms over
the blocks. The relaxed feed carries the rank's block-local flat ids, as
on one rank; the one writer (``distributed.checkpoint``) maps them into
the (T * R, d) stacked tables, the one-rank checkpoint's layout. The
collectives go through the mesh's helpers (``launch.mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import relaxed as rx
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.distributed import fsdp, sharding, tensor_parallel
from repro_torch.kernels import ops
from repro_torch.models.registry import get_api
from repro_torch.optim import optimizers as opt
from repro_torch.training import state as st
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path


def tree_items(tree) -> list:
    """(path, leaf) for each leaf, in ``tree_leaves`` order."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def _add_updates_(params, updates) -> None:
    """p = (p.f32 + u).to(p.dtype), in place, leaf by leaf."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates), strict=True):
        p.copy_(p.float() + u)


def _sum_(mesh, ax, leaves, n) -> None:
    """Each of ``leaves`` becomes its sum over ``ax`` divided by ``n``, in
    place: one all-reduce per dtype."""
    for dt in dict.fromkeys(g.dtype for g in leaves):
        same = [g for g in leaves if g.dtype == dt]
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in same]), ax)
        if n != 1:
            flat = flat / n
        for g, part in zip(same, flat.split([g.numel() for g in same]), strict=True):
            g.copy_(part.view(g.shape))


def _summed_over_data(cfg, path, g, ax, mesh) -> bool:
    """Whether the grad of the leaf at ``path`` arrives summed over the
    data-parallel axes ``ax``: a leaf held in blocks over them, whose
    gather's backward reduce-scattered it (``distributed.fsdp``)."""
    held = set(fsdp.held_dims(cfg, path, g.dim()).values())
    want = {ax} if isinstance(ax, str) else set(ax)
    want = {a for a in want if mesh.axis_size(a) > 1}
    if held & want and not want <= held:
        raise NotImplementedError(f"{path}: held in blocks over {sorted(held & want)} "
                                  f"of the data-parallel axes {sorted(want)}")
    return bool(held & want)


def sync_dense_(g_dense, loss, cfg):
    """Under a sharding context, in place: the grads of the replicated
    leaves that saw only the rank's rows or heads under tensor parallelism
    (``tensor_parallel.partial_leaf``) summed over the TP axis; then each
    dense grad becomes the sum over the data-parallel axes divided by
    their size (one all-reduce per dtype), and the loss the mean over
    them. Returns the loss. A leaf of ``cfg``'s held in blocks over the
    data-parallel axes (FSDP) arrives summed over them by its gather's
    backward (``distributed.fsdp``) and is only divided."""
    ctx = sharding.current()
    if ctx is None:
        return loss
    mesh = ctx.mesh
    items = tree_items(g_dense)
    part = [g for path, g in items if tensor_parallel.partial_leaf(path)]
    if part:
        _sum_(mesh, ctx.tp, part, 1)
    ax = ctx.axes("batch")
    dp = mesh.axis_size(ax)
    if dp == 1:
        return loss
    done = [_summed_over_data(cfg, path, g, ax, mesh) for path, g in items]
    _sum_(mesh, ax, [g for (_, g), d in zip(items, done, strict=True) if not d], dp)
    for (_, g), d in zip(items, done, strict=True):
        if d:
            g.div_(dp)
    return mesh.all_reduce(loss, ax) / dp


def clip_split(g_dense, cfg):
    """``global_norm_clip_``'s ``split`` where a rank holds blocks of some
    of ``cfg``'s leaves (None otherwise): for each leaf the mesh axes its
    blocks lie over (``()`` for a leaf held whole), and the sum over such
    axes."""
    ctx = sharding.current()
    if ctx is None:
        return None
    names = ctx.mesh.axis_names
    keys = [tuple(a for a in names if a in fsdp.held_dims(cfg, path, g.dim()).values())
            for path, g in tree_items(g_dense)]
    if not any(keys):
        return None
    return keys, (lambda x, axes: ctx.mesh.all_reduce(x, axes))


def make_step_fns(cfg, train_cfg):
    """Returns (init_fn, strict_step, relaxed_step, warmup_fn).

    ``init_fn(params)`` builds the train state from a param tree (the JAX
    package's takes a PRNG key; torch cannot reproduce its draws); under a
    mesh, from the rank's tree (``sharding.shard_params``). The steps read
    the sharding context when they run.
    """
    api = get_api(cfg)
    rx.check_trainable(cfg)
    tied = bool(cfg.tie_embeddings)
    leaf = rx.embed_leaf(cfg)
    embed_opt = opt.make_optimizer(train_cfg.embed_optimizer,
                                   train_cfg.embed_learning_rate)
    if embed_opt.update_rows is None:
        raise NotImplementedError(
            f"embed_optimizer={train_cfg.embed_optimizer!r} has no "
            "touched-rows form (it moves rows the batch did not touch); the "
            "sparse embedding update takes 'sgd' and 'rowwise_adagrad'")
    dense_opt = opt.make_optimizer(train_cfg.optimizer, train_cfg.learning_rate,
                                   train_cfg)

    def init_fn(params):
        return st.make_state(params, dense_opt, embed_opt)

    def loss_and_grads(state, rows, batch):
        """Loss, dense-param grads, the grad w.r.t. the looked-up rows and,
        for a tied head, the head's grad w.r.t. the table (else None)."""
        dense = tree_map(lambda p: p.detach().requires_grad_(), state["dense"])
        rows = rows.detach().requires_grad_()
        embed = state["embed"]
        if tied:
            embed = {**embed, leaf: embed[leaf].detach().requires_grad_()}
        loss = api.loss(st.merge_params(dense, embed), cfg,
                        {**batch, "embed_rows": rows})
        leaves = tree_leaves(dense)
        extra = [rows, embed[leaf]] if tied else [rows]
        grads = torch.autograd.grad(loss, leaves + extra)
        it = iter(grads[:len(leaves)])
        g_head = grads[-1] if tied else None
        return (loss.detach(), tree_map(lambda _: next(it), dense),
                grads[len(leaves)], g_head)

    def update_dense(state, g_dense, loss):
        """In place: sums the fresh grads over the data-parallel axes under
        a mesh, clips them, then updates the dense params and the
        optimizer's moments. Returns (dense, opt state, norm, loss)."""
        loss = sync_dense_(g_dense, loss, cfg)
        if train_cfg.grad_clip:
            gnorm = opt.global_norm_clip_(g_dense, train_cfg.grad_clip,
                                          clip_split(g_dense, cfg))
        else:
            gnorm = torch.zeros(())
        if dense_opt.update_inplace is not None:
            od = dense_opt.update_inplace(g_dense, state["opt_dense"], state["dense"])
        else:
            upd_d, od = dense_opt.update(g_dense, state["opt_dense"], state["dense"])
            _add_updates_(state["dense"], upd_d)
        return state["dense"], od, gnorm, loss

    def sparse_update(state, batch, g_rows, g_head):
        """The embedding optimizer at the touched rows: (uniq row ids, f32
        row updates, opt state). With a tied head every row is touched:
        the rows' gradient is added into the head's (V, d) one, at their
        rows, and the ids are 0 .. V-1."""
        table = state["embed"][leaf]
        uniq, g_emb = rx.sparse_rows_grad(state["embed"], cfg, batch, g_rows)
        if g_head is not None:
            g_all = g_head.float()
            ops.scatter_update(g_all, uniq, g_emb)
            uniq = torch.arange(table.shape[0], dtype=torch.int32, device=table.device)
            g_emb = g_all
        kw = {}
        if cfg.arch_type == "dlrm":
            kw["rows"], _, kw["psum"] = rx.block(cfg, table)
        upd, oe = embed_opt.update_rows(uniq, g_emb, state["opt_embed"],
                                        tuple(table.shape), **kw)
        return uniq, upd, oe

    # -- strict ------------------------------------------------------------
    @torch.no_grad()
    def strict_step(state, batch):
        rows = rx.lookup_rows(state["embed"], cfg, batch)
        with torch.enable_grad():
            loss, g_dense, g_rows, g_head = loss_and_grads(state, rows, batch)
        dense, od, gnorm, loss = update_dense(state, g_dense, loss)
        uniq, upd, oe = sparse_update(state, batch, g_rows, g_head)
        rx.apply_embed_update(state["embed"], cfg, uniq, upd)
        new_state = {**state, "dense": dense, "opt_dense": od, "opt_embed": oe,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    # -- relaxed -----------------------------------------------------------
    @torch.no_grad()
    def warmup(state, batch0):
        """Fill the prefetch carry for step 0 and allocate the correction's
        zeroed f32 scratch of the table's shape (none for a tied head, whose
        correction reads its dense update)."""
        table = state["embed"][leaf]
        scratch = None if tied else torch.zeros(table.shape, dtype=torch.float32,
                                                device=table.device)
        return {**state, "prefetch": {
            "rows": rx.lookup_rows(state["embed"], cfg, batch0), "scratch": scratch}}

    @torch.no_grad()
    def relaxed_step(state, batch, next_batch):
        carry = state["prefetch"]
        with torch.enable_grad():
            loss, g_dense, g_rows, g_head = loss_and_grads(state, carry["rows"], batch)
        # batch N+1's stale rows, read before the in-place update below
        stale = rx.lookup_rows(state["embed"], cfg, next_batch)
        dense, od, gnorm, loss = update_dense(state, g_dense, loss)
        uniq, upd, oe = sparse_update(state, batch, g_rows, g_head)
        old_rows = rx.apply_embed_update_logged(state["embed"], cfg, uniq, upd)
        rows_next = rx.prefetch_corrected(stale, carry["scratch"], uniq, upd,
                                          cfg, next_batch)
        new_state = {**state, "dense": dense, "opt_dense": od, "opt_embed": oe,
                     "step": state["step"] + 1,
                     "prefetch": {**carry, "rows": rows_next}}
        # for the batch-aware checkpoint: the flat ids of the rows this step
        # updated (distinct, ascending, then -1 pads; under a mesh, ids into
        # the rank's block), their f32 deltas, and the undo image: the
        # pre-update rows of exactly those ids, in the table's dtype (+0 at
        # the pads), captured by the update itself
        ckpt_feed = {"touched": uniq, "delta": upd, "old_rows": old_rows}
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "ckpt_feed": ckpt_feed}

    return init_fn, strict_step, relaxed_step, warmup


def init_state(cfg, train_cfg, device="cuda"):
    """A fresh train state, the params drawn from ``train_cfg.seed`` on
    ``device``; under a sharding context each rank keeps its part of them
    as they are drawn (``sharding.keep_shard``)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(train_cfg.seed)
    ctx = sharding.current()
    kw = {} if ctx is None else {"keep": sharding.keep_shard(ctx.mesh, ctx.rules)}
    return make_step_fns(cfg, train_cfg)[0](get_api(cfg).init(gen, cfg, **kw))


def train(cfg, train_cfg, batches, num_steps: int, *, relaxed: bool = True,
          state=None, start_step: int = 0, ckpt_manager=None,
          on_metrics: Optional[Callable] = None, device="cuda",
          checkpoint_dir: Optional[str] = None,
          pool_backend: Optional[str] = None):
    """Host-side loop. Returns (state, losses).

    Without ``state`` the params are drawn from ``train_cfg.seed`` on
    ``device`` (default ``cuda``; raises when there is no card, unless the
    caller passes ``device="cpu"``). ``batches`` must emit tensors on the
    same device.

    ``ckpt_manager.on_step`` runs after every step (strict steps give it no
    feed, and it logs nothing for them), and the manager is flushed before
    returning. ``checkpoint_dir``/``pool_backend`` build a manager over the
    dram or pmem pool when the caller passed none; the loop closes a
    manager it built.

    Under a sharding context every rank runs this loop on the same global
    batches and keeps its slice of each (``sharding.shard_batch``); a
    fresh state holds the rank's part of the params, and the manager the
    loop builds is a ``distributed.checkpoint.MeshCheckpoint`` (one writer,
    the one-rank layout).
    """
    # full-f32 matmuls on the card, as the JAX reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    _, strict_step, relaxed_step, warmup = make_step_fns(cfg, train_cfg)
    ctx = sharding.current()
    if ctx is None:
        def draw(step):
            return batches.next(step)
    else:
        def draw(step):
            return sharding.shard_batch(batches.next(step), ctx.mesh, ctx.rules)
    if state is None:
        state = init_state(cfg, train_cfg, device)
    own_manager = False
    if ckpt_manager is None and checkpoint_dir:
        cc = dataclasses.replace(
            train_cfg.checkpoint, directory=checkpoint_dir,
            **({"pool_backend": pool_backend} if pool_backend else {}))
        if ctx is None:
            ckpt_manager = CheckpointManager(cfg, cc, embed_init=state["embed"])
        else:
            from repro_torch.distributed.checkpoint import MeshCheckpoint
            ckpt_manager = MeshCheckpoint(cfg, cc, embed_init=state["embed"])
        own_manager = True
    losses = []
    if relaxed and state.get("prefetch") is None:
        state = warmup(state, draw(start_step))
    for n in range(start_step, start_step + num_steps):
        batch = draw(n)
        if relaxed:
            state, metrics = relaxed_step(state, batch, draw(n + 1))
        else:
            state, metrics = strict_step(state, batch)
        losses.append(float(metrics["loss"]))
        if ckpt_manager is not None:
            ckpt_manager.on_step(n, state, metrics.get("ckpt_feed"))
        if on_metrics is not None:
            on_metrics(n, metrics)
    if ckpt_manager is not None:
        ckpt_manager.flush()
        if own_manager:
            ckpt_manager.close()   # release the pool file it opened
    return state, losses
