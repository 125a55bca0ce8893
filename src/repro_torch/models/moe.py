"""Mixture-of-Experts FFN with top-k routing (counterpart of
``repro.models.moe``). Without a mesh every expert runs on one card; under
a sharding context the experts run expert-parallel: each rank holds ``E /
n`` of them (``n`` the ``model`` axis), takes their windows of the global
plan with the same capacity, and its partial output is summed over
``model`` by ``all_reduce``, as the reference's ``shard_map`` body does.

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

from repro_torch.distributed import sharding
from repro_torch.models import layers

_record: list | None = None   # set by ``recording``


@contextlib.contextmanager
def recording():
    """Collects, for every ``moe_fwd`` inside the context, a dict of its
    routing: ``x`` (T, d), the tokens' input rows, ``choice`` (T, k), the
    experts each token chose, and ``dropped`` (T, k) bool, the (token,
    slot) pairs that capacity dropped (on the activations' device,
    unsynchronised)."""
    global _record
    prev, _record = _record, []
    try:
        yield _record
    finally:
        _record = prev


def init_moe(gen: torch.Generator, cfg, new=None, keep=None):
    """The router, the experts and arctic's dense FFN. ``keep(path, leaf)``
    cuts each expert leaf once drawn (a rank's experts): the leaf is drawn
    whole, then its part goes to ``new``."""
    d = cfg.d_model
    e, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
    dt = cfg.activation_dtype
    scale = math.sqrt(1.0 / d)

    def experts(name, shape, scale):
        if keep is None:
            return layers.uniform_init(gen, shape, scale, dt, new)
        part = keep(f"moe/{name}", layers.uniform_init(gen, shape, scale, dt))
        return (new or layers.fresh(gen.device))(part.shape, dt).copy_(part)
    p = {"router": layers.dense_init(gen, d, e, torch.float32, new),
         "wi": experts("wi", (e, d, f), scale),
         "wg": experts("wg", (e, d, f), scale),
         "wo": experts("wo", (e, f, d), math.sqrt(1.0 / f))}
    if cfg.moe.dense_residual:
        p["dense"] = layers.init_mlp(gen, cfg, new=new)   # arctic: parallel dense FFN
    return p


def _capacity(T: int, k: int, e: int, factor: float = 1.25) -> int:
    c = int(math.ceil(T * k / e * factor))
    return max(8, -(-c // 8) * 8)  # round up to 8


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _F32Matmul(torch.autograd.Function):
    """a @ b in full f32, its backward's products too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _no_tf32():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _no_tf32():
            return g @ b.T, a.T @ g


def route(router_w, xt, top_k: int):
    """Router: returns (gate (T, k), choice (T, k), aux). xt: (T, d)."""
    logits = _F32Matmul.apply(xt.float(), router_w)            # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate, choice = torch.topk(probs, top_k, dim=-1)            # descending
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    e = router_w.shape[1]
    flat = choice.reshape(-1)
    counts = torch.zeros(e, dtype=torch.long, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    me = probs.mean(0)
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
               e_offset: int = 0):
    """Dispatch pre-routed tokens to the experts in (wi, wg, wo).

    xt: (T, d); gate/choice: (T, k); wi/wg: (E_loc, d, f); wo: (E_loc, f, d),
    the experts ``e_offset .. e_offset + E_loc - 1`` of ``num_experts``.
    They take their windows of the global plan (capacity ``capacity``); a
    token's kept slots at other experts read a zero row, so the (T, d)
    output, in the products' dtype, is this rank's part of the sum.
    """
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
    h = torch.bmm(xe, wi)
    g = torch.bmm(xe, wg)
    y = torch.bmm(F.silu(g) * h, wo)
    y = y * gts[..., None].to(y.dtype)                         # gate (+mask drops)
    return _Combine.apply(y.reshape(e_loc * C, d), src, slot)


def _moe_ep(p, cfg, x, ctx):
    """The expert-parallel path (the reference's ``shard_map`` body): this
    rank's experts over the tokens of every data group, its partial output
    summed over ``model``.

    x: (B, S, d), whole on every rank; under a ``seq`` rule (S > 1) this
    rank's sequence block, all-gathered first and the output
    reduce-scattered back. The routing and its aux are computed on every
    rank over the whole batch (the reference's "pjit side"). Each data
    group (the batch split over the ``batch`` rule's axes, as the reference
    splits it) takes its own capacity windows; the groups run one after
    the other here, where each rank holds the whole batch.
    """
    mesh = ctx.mesh
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    tp = mesh.axis_size("model")
    if e % tp:
        raise ValueError(f"{cfg.name}: {e} experts do not split over {tp} ranks")
    e_loc = e // tp
    seq_ax = ctx.axes("seq") if x.shape[1] > 1 else None
    if seq_ax is not None:
        x = mesh.all_gather(x, seq_ax, dim=1)
    B, S, d = x.shape
    gate, choice, aux = route(p["router"], x.reshape(B * S, d), k)
    dp = ctx.axes("batch")
    dp_total = mesh.axis_size(dp)
    if B % dp_total:
        dp_total = 1                                        # batch unshardable
    b_loc = B // dp_total
    C = _capacity(b_loc * S, k, e)
    e_offset = mesh.axis_index("model") * e_loc
    held = [p[n] if p[n].shape[0] == e_loc else p[n][e_offset:e_offset + e_loc]
            for n in ("wi", "wg", "wo")]
    parts = []
    for g in range(dp_total):
        t = slice(g * b_loc * S, (g + 1) * b_loc * S)
        parts.append(_moe_local(x.reshape(B * S, d)[t], gate[t], choice[t], *held,
                                num_experts=e, capacity=C, e_offset=e_offset))
    out = torch.cat(parts).reshape(B, S, d)
    if seq_ax is not None:
        out = mesh.reduce_scatter(out, seq_ax, dim=1)
    else:
        out = mesh.all_reduce(out, "model")
    return out, aux


def moe_fwd(p, cfg, x):
    """x: (B, S, d) -> ((B, S, d), aux). Capacity-dropped tokens pass
    through 0. Under a sharding context the experts run expert-parallel
    (``_moe_ep``; ``wi``, ``wg``, ``wo`` this rank's experts or all of
    them)."""
    B, S, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    ctx = sharding.current()
    if ctx is None or "model" not in ctx.mesh_axes:
        gate, choice, aux = route(p["router"], x.reshape(B * S, d), k)
        out = _moe_local(x.reshape(B * S, d), gate, choice, p["wi"], p["wg"], p["wo"],
                         num_experts=e, capacity=_capacity(B * S, k, e))
        out = out.reshape(B, S, d)
    else:
        out, aux = _moe_ep(p, cfg, x, ctx)
    if cfg.moe.dense_residual:
        out = out + layers.mlp_fwd(p["dense"], cfg, x)
    return out.to(x.dtype), aux


def touched_experts(cfg, choice):
    """Expert ids touched by a batch: the sparse tier's undo-log set."""
    e = cfg.moe.num_experts
    return torch.zeros(e, dtype=torch.bool, device=choice.device) \
        .index_fill_(0, choice.reshape(-1), True)
