"""Mixture-of-Experts FFN with top-k routing (counterpart of
``repro.models.moe``). Without a mesh every expert runs on one card; under
a sharding context the experts run expert-parallel: each rank holds ``E /
n`` of them (``n`` the ``model`` axis), takes their windows of its data
group's plan, and its partial output is summed over ``model`` (an
all-reduce, or a reduce-scatter back to the sequence shards under a
``seq`` rule), as the reference's ``shard_map`` body does. In training
(``moe_fwd(..., local_batch=True)``) the collectives are autograd's
operators (``distributed.tensor_parallel``), each rank routes its own
data group's tokens, and the load-balancing term is the global batch's
(``route``'s ``over``).

Routing is the reference's: f32 router logits (no TF32 on the card, in the
forward or the backward), softmax, top-k, gates renormalised, and the load
balancing term ``aux = E * sum(mean(probs) * counts / sum(counts))``.

Dispatch is the reference's too: the (token, slot) pairs are ordered by a
stable sort of their expert id, each expert takes a window of ``capacity``
sorted pairs, and the pairs past an expert's capacity are dropped (they add
nothing to the token's output). The three expert products are batched
matmuls over the (E, C, d) windows.

The dispatch gather and the combine are one adjoint pair, both sums in a
fixed order with no atomics (``_Dispatch``, ``_Combine``): a (T, k) map
sends each token to its kept window slots in ascending expert order, with a
sentinel for a dropped slot. The combine adds a token's slot outputs in that
order, as the reference's scatter-add does; the backward of the gather is
that same combine, and the backward of the combine is the gather. Window
slots past an expert's count (the reference reads the next expert's tokens
there, with gate 0) read a zero row and add nothing, so every sum is the
reference's, but the card's run repeats bit for bit (``index_add_`` and
the backward of an indexing read would add in a racing order). The pair is
plain torch, not the port's bag kernel: that kernel accumulates in f32 and
returns f32, where the reference adds the gated rows in the activation
dtype, one rounding per add.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import fsdp, sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers

_record: list | None = None   # set by ``recording``


@contextlib.contextmanager
def recording():
    """Collects, for every ``moe_fwd`` inside the context, a dict of its
    routing: ``x`` (T, d), the tokens' input rows, ``choice`` (T, k), the
    experts each token chose, and ``dropped`` (T, k) bool, the (token,
    slot) pairs that capacity dropped (on the activations' device,
    unsynchronised); one a data group where a rank serves several, the
    last of a call with ``aux``, its load-balancing term."""
    global _record
    prev, _record = _record, []
    try:
        yield _record
    finally:
        _record = prev


def init_moe(gen: torch.Generator, cfg, new=None, keep=None):
    """The router, the experts and arctic's dense FFN. ``keep(path, leaf)``
    cuts each leaf once drawn (a rank's experts, and under a ``heads`` or
    ``w_embed`` rule its blocks of the router and the dense FFN): the leaf
    is drawn whole, then its part goes to ``new``."""
    d = cfg.d_model
    e, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
    dt = cfg.activation_dtype
    scale = math.sqrt(1.0 / d)

    def experts(name, shape, scale):
        if keep is None:
            return layers.uniform_init(gen, shape, scale, dt, new)
        part = keep(f"moe/{name}", layers.uniform_init(gen, shape, scale, dt))
        return (new or layers.fresh(gen.device))(part.shape, dt).copy_(part)
    p = {"router": layers.dense_init(gen, d, e, torch.float32, new, keep, "moe/router"),
         "wi": experts("wi", (e, d, f), scale),
         "wg": experts("wg", (e, d, f), scale),
         "wo": experts("wo", (e, f, d), math.sqrt(1.0 / f))}
    if cfg.moe.dense_residual:       # arctic: parallel dense FFN, held as an MLP's
        p["dense"] = layers.init_mlp(gen, cfg, new=new, keep=keep)
    return p


def _capacity(T: int, k: int, e: int, factor: float = 1.25) -> int:
    c = int(math.ceil(T * k / e * factor))
    return max(8, -(-c // 8) * 8)  # round up to 8


class _GlobalSum(torch.autograd.Function):
    """The sum of ``x`` over the data-parallel axes ``ax`` (an all-reduce);
    the backward scales the gradient by ``scale`` and moves nothing (each
    rank's part of the sum is its own tokens')."""

    @staticmethod
    def forward(ctx, x, mesh, ax, scale):
        ctx.scale = scale
        return mesh.all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None, None


def route(router_w, xt, top_k: int, mm=None, over=None):
    """Router: returns (gate (T, k), choice (T, k), aux). xt: (T, d).
    ``mm``: the logits' product (default: full f32, TF32 off).

    ``over``: (mesh, data-parallel axes, scale) where ``xt`` is one data
    group's tokens of a batch split over those axes (training under a
    mesh): aux is then the reference's over the global batch, the
    probabilities' and the counts' sums over the groups taken before it is
    formed, and its gradient is scaled by ``scale`` (the trainer's
    convention, ``models.transformer._global_count``: the ranks' gradients
    are averaged over the data axes, so each rank's part counts their
    number of times; and a rank of ``model`` counts the part that it
    shares with the others once over them)."""
    logits = (mm or fsdp.f32_matmul)(xt.float(), router_w)       # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate, choice = torch.topk(probs, top_k, dim=-1)            # descending
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    e = router_w.shape[1]
    flat = choice.reshape(-1)
    counts = torch.zeros(e, dtype=torch.long, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    if over is None:
        me = probs.mean(0)
    else:
        mesh, ax, scale = over
        n = mesh.axis_size(ax)
        me = _GlobalSum.apply(probs.sum(0), mesh, ax, scale) / (xt.shape[0] * n)
        counts = mesh.all_reduce(counts, ax)
    ce = (counts / torch.clamp(counts.sum(), min=1)).float()
    aux = e * torch.sum(me * ce)
    return gate, choice, aux


def _rows(x, idx):
    """x[idx] with the index len(x) reading a zero row."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))]).index_select(0, idx)


def _ordered_sum(y, slot):
    """out[t] = y[slot[t, 0]] + y[slot[t, 1]] + ... in that order, the
    index len(y) a zero row."""
    yp = torch.cat([y, y.new_zeros((1, y.shape[1]))])
    out = yp.index_select(0, slot[:, 0])
    for j in range(1, slot.shape[1]):
        out = out + yp.index_select(0, slot[:, j])
    return out


class _Dispatch(torch.autograd.Function):
    """xe[s] = xt[src[s]] (a zero row where src[s] == T); its backward is
    the combine over ``slot``."""

    @staticmethod
    def forward(ctx, xt, src, slot):
        ctx.save_for_backward(src, slot)
        return _rows(xt, src)

    @staticmethod
    def backward(ctx, g):
        src, slot = ctx.saved_tensors
        return _ordered_sum(g, slot), None, None


class _Combine(torch.autograd.Function):
    """out[t] = sum of y over t's kept window slots, in ascending expert
    order; its backward is the gather over ``src``."""

    @staticmethod
    def forward(ctx, y, src, slot):
        ctx.save_for_backward(src, slot)
        return _ordered_sum(y, slot)

    @staticmethod
    def backward(ctx, g):
        src, slot = ctx.saved_tensors
        return _rows(g, src), None, None


def _plan(choice, num_experts: int, capacity: int):
    """The capacity windows of pre-routed tokens. choice: (T, k).

    Returns (src, slot, gate_idx, dropped): src (E*C,) the token in each
    window slot (T where the slot is past its expert's count); slot (T, k)
    each token's window slots in ascending expert order (E*C for a pair
    capacity dropped); gate_idx (E*C,) the flat (token, slot) pair behind
    each window slot (T*k past the count); dropped (T, k) bool.
    """
    T, k = choice.shape
    E, C = num_experts, capacity
    dev = choice.device
    flat = choice.reshape(-1)                                  # (T*k,)
    order = torch.sort(flat, stable=True).indices              # pairs by expert
    counts = torch.zeros(E, dtype=torch.long, device=dev) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    offsets = torch.cumsum(counts, 0) - counts
    c = torch.arange(C, device=dev)
    valid = c[None, :] < counts[:, None]                       # (E, C)
    pos = (offsets[:, None] + c[None, :]).clamp(max=T * k - 1)
    pair = torch.where(valid, order[pos], T * k)               # (E, C)
    src = torch.where(valid, pair // k, T).reshape(-1)
    # each pair's place in its expert's window
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(T * k, device=dev))
    within = rank - offsets[flat]
    dropped = (within >= C).reshape(T, k)
    slot = torch.where(dropped.reshape(-1), E * C, flat * C + within).reshape(T, k)
    slot = slot.gather(1, torch.sort(choice, dim=1).indices)   # ascending expert
    return src, slot, pair.reshape(-1), dropped


def _moe_local(xt, gate, choice, wi, wg, wo, *, num_experts: int, capacity: int,
               e_offset: int = 0, mm=None):
    """Dispatch pre-routed tokens to the experts in (wi, wg, wo).

    xt: (T, d); gate/choice: (T, k); wi/wg: (E_loc, d, f); wo: (E_loc, f, d),
    the experts ``e_offset .. e_offset + E_loc - 1`` of ``num_experts``.
    They take their windows of the global plan (capacity ``capacity``); a
    token's kept slots at other experts read a zero row, so the (T, d)
    output, in the products' dtype, is this rank's part of the sum.
    ``mm(x, w, name)``: the batched product with the expert stack ``name``
    (default ``torch.bmm``; under FSDP its held block gathered at its use).
    """
    mm = mm or (lambda a, w, _: torch.bmm(a, w))
    T, d = xt.shape
    E, C = num_experts, capacity
    e_loc = wi.shape[0]
    src, slot, gate_idx, dropped = _plan(choice, E, C)
    if _record is not None:
        _record.append({"x": xt, "choice": choice, "dropped": dropped})
    if e_loc != E:
        lo, hi = e_offset * C, (e_offset + e_loc) * C
        src, gate_idx = src[lo:hi], gate_idx[lo:hi]
        slot = torch.where((slot >= lo) & (slot < hi), slot - lo, e_loc * C)
    gts = torch.cat([gate.reshape(-1), gate.new_zeros(1)])[gate_idx].reshape(e_loc, C)
    xe = _Dispatch.apply(xt, src, slot).reshape(e_loc, C, d)
    h = mm(xe, wi, "moe/wi")
    g = mm(xe, wg, "moe/wg")
    y = mm(F.silu(g) * h, wo, "moe/wo")
    y = y * gts[..., None].to(y.dtype)                         # gate (+mask drops)
    return _Combine.apply(y.reshape(e_loc * C, d), src, slot)


def _moe_ep(p, cfg, x, ctx, local_batch: bool = False):
    """The expert-parallel path (the reference's ``shard_map`` body): this
    rank's experts over the tokens of its data group, its partial output
    summed over ``model``.

    x: (B, S, d); under a ``seq`` rule (S > 1) this rank's sequence block,
    all-gathered first and the output reduce-scattered back (the backward
    the reverse of each); else whole on every model rank, the output
    all-reduced (the backward: the input's gradient summed over ``model``).
    The routing is computed on every model rank, the same, token by token.
    Each data group (the batch split over the ``batch`` rule's axes, as the
    reference splits it) takes its own capacity windows, and a rank runs
    the groups it holds one after the other: in serving (``local_batch``
    False) every group, the whole batch being on every rank (aux the whole
    batch's, the reference's "pjit side"); in training (``local_batch``)
    its own, the batch being its group's part (``sharding.shard_batch``),
    and aux the global batch's (``route``'s ``over``), its gradient scaled
    by dp / tp (``route``).
    Under FSDP the router and the experts are gathered over ``data`` at
    their use (``distributed.fsdp``).
    """
    mesh = ctx.mesh
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    tp_n = mesh.axis_size("model")
    if e % tp_n:
        raise ValueError(f"{cfg.name}: {e} experts do not split over {tp_n} ranks")
    e_loc = e // tp_n
    seq_ax = ctx.axes("seq") if x.shape[1] > 1 else None
    if seq_ax is not None:
        x = tp.gather(x, mesh, seq_ax, 1)
    elif local_batch:
        x = tp.copy(x, mesh, "model")
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    dp = ctx.axes("batch")
    dp_total = mesh.axis_size(dp)

    def router(a, w):
        return fsdp.mm(a, w, cfg, "moe/router", f32=True)

    def experts(a, w, name):
        return fsdp.mm(a, w, cfg, name)
    e_offset = mesh.axis_index("model") * e_loc
    held = [p[n] if p[n].shape[0] == e_loc else p[n][e_offset:e_offset + e_loc]
            for n in ("wi", "wg", "wo")]
    over = (mesh, dp, dp_total / tp_n) if local_batch else None
    gate, choice, aux = route(p["router"], xt, k, router, over=over)
    groups = 1 if local_batch or B % dp_total else dp_total    # the groups held here
    n = B * S // groups
    C = _capacity(n, k, e)
    out = torch.cat([_moe_local(xt[t], gate[t], choice[t], *held, num_experts=e,
                                capacity=C, e_offset=e_offset, mm=experts)
                     for t in (slice(g * n, (g + 1) * n) for g in range(groups))])
    out = out.reshape(B, S, d)
    if seq_ax is not None:
        out = tp.reduce_scatter(out, mesh, seq_ax, 1)
    else:
        out = tp.reduce(out, mesh, "model")
    return out, aux


def moe_fwd(p, cfg, x, local_batch: bool = False):
    """x: (B, S, d) -> ((B, S, d), aux). Capacity-dropped tokens pass
    through 0. Under a sharding context the experts run expert-parallel
    (``_moe_ep``; ``wi``, ``wg``, ``wo`` this rank's experts or all of
    them; ``local_batch``: the batch is the rank's data group's, as the
    trainer splits it), and arctic's dense FFN as an MLP (tensor-parallel
    under a ``heads`` rule)."""
    B, S, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    ctx = sharding.current()
    if ctx is None or "model" not in ctx.mesh_axes:
        gate, choice, aux = route(p["router"], x.reshape(B * S, d), k)
        out = _moe_local(x.reshape(B * S, d), gate, choice, p["wi"], p["wg"], p["wo"],
                         num_experts=e, capacity=_capacity(B * S, k, e))
        out = out.reshape(B, S, d)
    else:
        out, aux = _moe_ep(p, cfg, x, ctx, local_batch)
    if _record is not None:
        _record[-1]["aux"] = aux.detach()
    if cfg.moe.dense_residual:
        out = out + layers.mlp_fwd(p["dense"], cfg, x)
    return out.to(x.dtype), aux


def touched_experts(cfg, choice):
    """Expert ids touched by a batch: the sparse tier's undo-log set."""
    e = cfg.moe.num_experts
    return torch.zeros(e, dtype=torch.bool, device=choice.device) \
        .index_fill_(0, choice.reshape(-1), True)
