"""Functional optimizers over param trees (counterpart of ``repro.optim.optimizers``).

Two tiers, matching the paper:
  * dense tier (MLP/backbone): AdamW / SGD-momentum
  * sparse tier (embedding pool): plain SGD or row-wise Adagrad, *additive*
    update rules, which is what makes the relaxed embedding lookup exact.

``update(grads, state, params) -> (updates, state)`` returns f32 updates;
the caller adds them as ``(p.f32 + u).to(p.dtype)``. AdamW also has
``update_inplace(grads, state, params) -> state``, which writes the same
bits into the params and the moments in place (the trainer's dense tier
uses it), so that no second copy of the moments, no f32 update tree and no
second param tree is ever held.

The sparse tier's rules also have ``update_rows(uniq, g, state,
table_shape, rows=None, psum=None) -> (updates, state)``, the touched-rows
form the trainer runs: ``uniq`` are the flat row ids a step touched
(ascending, then -1 pads), ``g`` their (N, d) f32 gradients, and the f32
updates of those rows equal the dense ``update``'s there (a row with no
gradient gets a zero update and keeps its state). Under a mesh a rank
holds a block of each table's rows: ``table_shape`` is the block's,
``rows`` the global rows a table and ``psum`` the sum over the ranks that
hold the other blocks, for a rule whose state spans a whole table. SGD
with momentum has none: its momentum moves rows that the batch did not
touch.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

# A leaf of more elements than this is updated in place a slice of its
# leading axis at a time (a stacked leaf a layer or a few at a time), so
# that each f32 temporary stays near this size: rwkv6-3b's stacked
# cmix.wk, (32, 2560, 8960), would otherwise take 2.9 GB per temporary.
SLICE_ELEMS = 1 << 25


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]                # params -> state
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (updates, state)
    # (grads, state, params) -> state, params and moments updated in place
    update_inplace: Optional[Callable[[Any, Any, Any], Any]] = None
    # (uniq, g, state, table_shape, rows=None, psum=None) -> (row updates,
    # state): the sparse tier's touched-rows form, its state updated in place
    update_rows: Optional[Callable[..., tuple]] = None


def leaf_slices(*leaves):
    """Aligned views of same-shaped leaves that cover them: the leaves
    themselves, or for a leaf of more than ``SLICE_ELEMS`` elements runs of
    its leading axis of about that many elements each."""
    t = leaves[0]
    if t.dim() < 2 or t.numel() <= SLICE_ELEMS:
        yield leaves
        return
    step = max(1, SLICE_ELEMS // (t.numel() // t.shape[0]))
    for i in range(0, t.shape[0], step):
        yield tuple(x[i:i + step] for x in leaves)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(_zeros_f32, params)

    def update(grads, state, params):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m

    def update_rows(uniq, g, state, table_shape, rows=None, psum=None):
        return -lr * g, state

    return Optimizer(init, update,
                     update_rows=update_rows if momentum == 0.0 else None)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()

        def upd(m, v, p):
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            return u

        return tree_map(upd, m, v, params), {"m": m, "v": v, "t": t}

    def update_inplace(grads, state, params):
        """``update`` and ``(p.f32 + u).to(p.dtype)`` written into params,
        m and v in place, with the same per-element operations in the same
        order (so the same bits), leaf by leaf and slice by slice."""
        t = state["t"] + 1
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()
        for leaf in zip(tree_leaves(grads), tree_leaves(state["m"]),
                        tree_leaves(state["v"]), tree_leaves(params), strict=True):
            for g, m, v, p in leaf_slices(*leaf):
                g32 = g.float()
                m.mul_(b1).add_((1 - b1) * g32)
                v.mul_(b2).add_((1 - b2) * torch.square(g32))
                u = (m / bc1).mul_(-lr).div_(torch.sqrt(v / bc2).add_(eps))
                if weight_decay:
                    u.sub_(lr * weight_decay * p.float())
                if p.dtype == torch.float32:
                    p.add_(u)
                else:
                    p.copy_(p.float().add_(u))
        return {"m": state["m"], "v": state["v"], "t": t}

    return Optimizer(init, update, update_inplace)


def rowwise_adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    """Row-wise Adagrad for embedding tables: the accumulator keeps the
    param's leading axis, so an LM's (V, d) table has one per row (V, 1)
    and DLRM's stacked (T, R, d) tables one per table (T, 1, 1), as the
    JAX package shapes it (``repro/optim/optimizers.py:78-88``).

    The row delta uses the accumulator read before the batch plus this
    batch's mean squared gradient, as the JAX package does.
    """
    def init(params):
        return tree_map(
            lambda p: torch.zeros(p.shape[:1] + (1,) * (p.dim() - 1),
                                  dtype=torch.float32, device=p.device)
            if p.dim() >= 2 else torch.zeros((), dtype=torch.float32,
                                             device=p.device), params)

    def mean_sq(g):
        g32 = g.float()
        if g.dim() < 2:
            return torch.square(g32)
        return torch.mean(torch.square(g32), dim=tuple(range(1, g.dim())),
                          keepdim=True)

    def update(grads, state, params):
        new_a = tree_map(lambda a, g: a + mean_sq(g), state, grads)
        ups = tree_map(lambda g, a: -lr * g.float() / (torch.sqrt(a) + eps),
                       grads, new_a)
        return ups, new_a

    def update_rows(uniq, g, state, table_shape, rows=None, psum=None):
        """The update at the touched rows; the accumulator is updated in
        place.

        (V, 1), an LM: a = gather_rows(acc, uniq), then scatter_update
        writes a + msq (the row's mean of g squared) in f32, the same sum
        the row's update divides by. (T, 1, 1), DLRM: table t's increment
        is the sum of g squared over its touched rows (flat id // R), over
        R * d, one masked sum a table in a fixed order (no atomics, so a
        run repeats bitwise); the JAX package computes it in plain jnp,
        with no kernel. Its dense ``update`` takes the same mean over the
        whole table gradient, zeros included, so the two differ only in
        the f32 order of the sum. Pads (-1) carry a zero gradient and are
        not written. On a block of R_held of each table's ``rows`` rows
        (``table_shape`` (T, R_held, d), ``uniq`` block-local), the
        per-table sums are summed over the blocks by ``psum`` before the
        division by ``rows * d``, so that every rank adds the global
        table's mean."""
        from repro_torch.kernels import ops
        (acc,) = tree_leaves(state)
        g32 = g.float()
        if acc.dim() == 2:
            a = ops.gather_rows(acc, uniq.clamp(min=0))
            msq = torch.mean(torch.square(g32), dim=1, keepdim=True)
            ops.scatter_update(acc, uniq, msq)
            return -lr * g32 / (torch.sqrt(a + msq) + eps), state
        T, R, d = table_shape
        table = torch.where(uniq >= 0, torch.div(uniq, R, rounding_mode="floor"),
                            T - 1).long()
        ssq = torch.sum(torch.square(g32), dim=1)
        mine = table == torch.arange(T, device=uniq.device)[:, None]    # (T, N)
        sums = torch.where(mine, ssq, 0.0).sum(dim=1)
        if psum is not None:
            sums = psum(sums)
        per_table = acc.view(T)
        per_table.add_(sums / ((rows or R) * d))
        a = per_table[table].unsqueeze(1)
        return -lr * g32 / (torch.sqrt(a) + eps), state

    return Optimizer(init, update, update_rows=update_rows)


def make_optimizer(name: str, lr: float, cfg=None) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "sgdm":
        return sgd(lr, 0.9)
    if name == "adamw":
        return adamw(lr,
                     b1=getattr(cfg, "beta1", 0.9),
                     b2=getattr(cfg, "beta2", 0.95),
                     weight_decay=getattr(cfg, "weight_decay", 0.0))
    if name == "rowwise_adagrad":
        return rowwise_adagrad(lr)
    raise ValueError(name)


def _clip_scale(grads, max_norm: float, split=None):
    """(global f32 L2 norm of grads, the f32 scale that clips it).

    ``split``: ``(axes, psum)`` where a rank holds blocks of some leaves
    (tensor parallelism, FSDP), ``axes`` a tuple per leaf (in
    ``tree_leaves`` order) of the mesh axes its blocks lie over, ``()``
    for a leaf every rank holds whole, and ``psum(x, axes)`` the sum over
    the ranks of those axes. The squares of the blocks are summed over
    their axes and those of the whole leaves are counted once, so every
    rank clips by the one global norm (a norm of its own would clip each
    rank by another scale, and the whole leaves would drift apart)."""
    def sq(g):
        return torch.sum(torch.square(g.float()))
    leaves = tree_leaves(grads)
    if split is None:
        norm = torch.sqrt(sum(sq(g) for g in leaves))
    else:
        keys, psum = split
        zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        parts = {}
        for g, k in zip(leaves, keys, strict=True):
            if k:
                parts[k] = parts.get(k, zero) + sq(g)
        whole = sum((sq(g) for g, k in zip(leaves, keys, strict=True) if not k), zero)
        blocks = zero
        for k, part in parts.items():
            blocks = blocks + psum(part, k)
        norm = torch.sqrt(blocks + whole)
    return norm, torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def global_norm_clip(grads, max_norm: float):
    """Scale grads so their global f32 L2 norm is at most ``max_norm``.

    Returns (clipped grads, norm); the scale is cast to each grad's dtype
    before the multiply, as the JAX package does.
    """
    norm, scale = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def global_norm_clip_(grads, max_norm: float, split=None):
    """``global_norm_clip`` in place: scales each grad leaf with ``mul_``
    (the same bits as ``g * scale.to(g.dtype)``) and returns the norm.
    ``split``: as ``_clip_scale``'s (leaves held in blocks)."""
    norm, scale = _clip_scale(grads, max_norm, split)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return norm
