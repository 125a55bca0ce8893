"""Dense tensor parallelism and the Megatron-SP residual stream (port-only:
the reference gets both from XLA, which derives them from ``param_specs``
and the dry run's activation rules, ``src/repro/launch/dryrun.py:81-109``).

Under a context whose rules name ``heads`` (``sharding.ShardingContext.tp``,
the ``model`` axis; ``launch.dryrun.build_rules`` writes the rule) each
rank computes with its column block of ``wq|wk|wv|wi|wg`` (its ``Hq/tp``
query heads, ``Hkv/tp`` kv heads, ``ffn/tp`` MLP columns), its row block
of the attention and MLP ``wo``, and its vocab block of ``lm_head`` and
of the token table: the blocks it holds (``sharding.held_spec``), or under
FSDP its held blocks gathered over ``data`` at their use
(``distributed.fsdp``). Where ``model`` does not divide the kv heads
(granite-20b's one; ``kv_replicated``, the reference's ``kv_heads: None``)
a rank reads ``wk``/``wv`` whole and projects the kv heads that its own
query heads read (``kv_cols``): rank r's query heads ``[r Hq/tp, (r+1)
Hq/tp)`` read kv heads ``h // (Hq/Hkv)``, so its flash call sees plain GQA
over them. A block then runs as Megatron's:

    column-parallel:  y_r = enter(x) @ W_r        (no collective forward)
    row-parallel:     z   = fsdp.row_parallel(y_r, V_r) = leave(y_r @ V_r)

where a 16-bit ``y_r @ V_r`` is formed in f32 and ``leave``'s sum is
rounded once to 16 bits, as one rank's product rounds once.

With a ``seq`` rule over the same axis (``ShardingContext.sp``, the
reference's ``seq_shard_activations`` profile) the residual stream between
blocks is each rank's ``S/tp`` rows: the norms run on the shard, ``enter``
all-gathers the stream along the sequence before the column-parallel
projections (its backward reduce-scatters) and ``leave`` reduce-scatters
after the row-parallel ones (its backward all-gathers). Without it the
stream is whole on every rank, ``enter`` is the identity with an
all-reduce backward and ``leave`` an all-reduce with an identity
backward.

The operators are ``torch.autograd.Function``s over the mesh's helpers
(``launch/mesh.py``); every rank issues the same collectives in the same
order, in the backward and in a remat recompute too. Gloo forms the
all-gather and the reduce-scatter from all-reduces and moves bf16 as f32
copies (``Mesh._reduce``), so on two ranks sharing a card a collective
moves about ``tp`` times the textbook bytes.

The head is vocab-parallel (``vocab_xent``): each rank's logits are its
vocab block's, the max and the sum of exponentials are all-reduced over
the vocab axis in f32, the label's logit is taken on the rank that holds
it, and the loss is the same on every rank.

Which replicated leaves see only part of the work: under SP every norm
(each sees its rank's rows), and under TP the q/k norms of qwen3's
``qk_norm`` (each sees its rank's heads), mamba's conv, gated norm and
per-head leaves (its SSD heads) and the router (its experts). Their
gradients are partial sums over the TP axis (``partial_leaf``), which the
trainer sums (``training.train_loop.sync_dense_``).

The MoE block runs expert-parallel over the same ``model`` axis
(``models.moe``). Jamba's mamba mixer runs ``nh / tp`` SSD heads a rank
(``models.mamba``): its column-parallel ``in_proj`` takes the stream
through ``enter``, its row-parallel ``bc_proj`` and ``dt_proj`` are
summed over the ranks in f32 by ``psum`` (forward and backward: every
rank's scan reads the whole B, C and its heads' dt), the gated norm's sum
of squares likewise, and its row-parallel ``out_proj`` is closed by
``leave``.

The decoders of arch type ``transformer`` (dense and MoE) and ``jamba``
with an untied head are the families this runs; the rest raise under a
``heads`` or a ``w_embed`` rule (``check_supported``), ROADMAP queue 1
item 10(c).
"""
from __future__ import annotations

import re

import torch

from repro_torch.distributed import sharding

_SEQ = 1      # the sequence dimension of a (B, S, d) stream


def axis():
    """The mesh axis of dense tensor parallelism in force (None: off)."""
    ctx = sharding.current()
    return None if ctx is None else ctx.tp


def size() -> int:
    ctx = sharding.current()
    return 1 if ctx is None or ctx.tp is None else ctx.mesh.axis_size(ctx.tp)


def seq_parallel() -> bool:
    """Whether the residual stream is sharded by sequence (SP). A ``seq``
    rule without a ``heads`` one over the same axis raises."""
    ctx = sharding.current()
    if ctx is None or not ctx.axes("seq"):
        return False
    if not ctx.sp:
        raise NotImplementedError(
            f"a seq rule over {ctx.axes('seq')!r} shards the residual stream by "
            f"sequence (Megatron-SP), which the port runs only with dense tensor "
            f"parallelism over the same axis (a heads rule over it; it has "
            f"{ctx.tp!r})")
    return True


def mesh_decoder(cfg) -> bool:
    """Whether ``cfg`` is a decoder that the port runs under dense tensor
    parallelism and FSDP: arch type ``transformer`` (dense or MoE) or
    ``jamba``, an untied head."""
    return cfg.arch_type in ("transformer", "jamba") and not cfg.tie_embeddings


def check_supported(cfg) -> None:
    """Raises under a ``heads`` or a ``w_embed`` rule for a model the port
    does not yet run with dense tensor parallelism or FSDP (ROADMAP queue 1
    item 10(c)), and where the TP axis does not divide jamba's SSD heads (a
    rank runs whole heads)."""
    ctx = sharding.current()
    if ctx is None or (ctx.tp is None and ctx.fsdp is None):
        return
    if not mesh_decoder(cfg):
        raise NotImplementedError(
            f"{cfg.name}: dense tensor parallelism and FSDP (a heads or a w_embed "
            f"rule) run the decoders of arch type transformer (dense or MoE) and "
            f"jamba with an untied head; {cfg.arch_type}"
            f"{' with a tied head' if cfg.tie_embeddings else ''} under them is "
            "ROADMAP queue 1 item 10(c)")
    n = size()
    nh = cfg.mamba.num_heads(cfg.d_model)
    if cfg.arch_type == "jamba" and nh % n:
        raise NotImplementedError(
            f"{cfg.name}: {nh} SSD heads do not split over {n} model ranks (a rank "
            "runs whole heads of the scan)")


def _mesh_ax():
    ctx = sharding.current()
    return ctx.mesh, ctx.tp


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, mesh, ax):
        ctx.mesh, ctx.ax = mesh, ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.ax), None, None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g). ``dtype``: the
    sum rounded to it, and the gradient taken in it (the widening back is
    exact)."""

    @staticmethod
    def forward(ctx, x, mesh, ax, dtype=None):
        ctx.wide = x.dtype
        y = mesh.all_reduce(x, ax)
        return y if dtype is None else y.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.wide), None, None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, mesh, ax, dim):
        ctx.mesh, ctx.ax, ctx.dim = mesh, ax, dim
        return mesh.all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.ax, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward. ``dtype``:
    the sum rounded to it, and the gradient gathered in it (the widening
    back is exact)."""

    @staticmethod
    def forward(ctx, x, mesh, ax, dim, dtype=None):
        ctx.mesh, ctx.ax, ctx.dim, ctx.wide = mesh, ax, dim, x.dtype
        y = mesh.reduce_scatter(x, ax, dim)
        return y if dtype is None else y.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.ax, ctx.dim).to(ctx.wide), None, None, None, None


class _Split(torch.autograd.Function):
    """This rank's block of ``dim`` forward, all-gather backward (the
    reverse of ``_Gather`` for a tensor every rank holds whole)."""

    @staticmethod
    def forward(ctx, x, mesh, ax, dim):
        ctx.mesh, ctx.ax, ctx.dim = mesh, ax, dim
        n = mesh.axis_size(ax)
        if x.shape[dim] % n:
            raise ValueError(f"sequence parallelism: dim {dim} of {tuple(x.shape)} "
                             f"does not split over {n} ranks")
        step = x.shape[dim] // n
        return x.narrow(dim, mesh.axis_index(ax) * step, step).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), ctx.ax, ctx.dim), None, None, None


class _Psum(torch.autograd.Function):
    """All-reduce forward and backward: a sum of the ranks' partials whose
    every rank feeds its own part of the work (mamba's B, C and dt, the
    gated norm's sum of squares), so that the gradient of the sum is the
    sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, ax):
        ctx.mesh, ctx.ax = mesh, ax
        return mesh.all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.ax), None, None


def copy(x, mesh, ax):
    return _Copy.apply(x, mesh, ax)


def psum(x):
    """``x`` summed over the TP axis, and its gradient too (``_Psum``);
    ``x`` without tensor parallelism."""
    if size() == 1:
        return x
    mesh, ax = _mesh_ax()
    return _Psum.apply(x, mesh, ax)


def rank() -> int:
    """This rank's index along the TP axis (0 without one)."""
    if size() == 1:
        return 0
    mesh, ax = _mesh_ax()
    return mesh.axis_index(ax)


def reduce(x, mesh, ax):
    return _Reduce.apply(x, mesh, ax)


def gather(x, mesh, ax, dim):
    return _Gather.apply(x, mesh, ax, dim)


def reduce_scatter(x, mesh, ax, dim):
    return _ReduceScatter.apply(x, mesh, ax, dim)


def split(x, mesh, ax, dim):
    return _Split.apply(x, mesh, ax, dim)


def enter(x):
    """The (B, S|S/tp, d) stream as the column-parallel projections take it:
    whole (B, S, d), gathered along the sequence under SP."""
    if size() == 1:
        return x
    mesh, ax = _mesh_ax()
    return gather(x, mesh, ax, _SEQ) if seq_parallel() else copy(x, mesh, ax)


def leave(y, dtype=None):
    """A row-parallel projection's partial (B, S, d) summed over the ranks:
    each rank's S/tp rows of it under SP, whole without; rounded to
    ``dtype`` if given, its gradient then moved in ``dtype``."""
    if size() == 1:
        return y if dtype is None else y.to(dtype)
    mesh, ax = _mesh_ax()
    if seq_parallel():
        return _ReduceScatter.apply(y, mesh, ax, _SEQ, dtype)
    return _Reduce.apply(y, mesh, ax, dtype)


def shard_stream(x):
    """The whole (B, S, d) stream cut to this rank's S/tp rows under SP
    (the backward gathers the rows' gradients whole again), else ``x``."""
    if not seq_parallel() or size() == 1:
        return x
    mesh, ax = _mesh_ax()
    return split(x, mesh, ax, _SEQ)


def gather_stream(x):
    """The stream whole along the sequence under SP (the head's input),
    else ``x``."""
    if not seq_parallel() or size() == 1:
        return x
    mesh, ax = _mesh_ax()
    return gather(x, mesh, ax, _SEQ)


def kv_replicated(cfg) -> bool:
    """Whether each rank reads the kv heads whole: dense tensor parallelism
    over more ranks than divide ``cfg``'s kv heads (the reference's
    ``kv_heads: None``)."""
    n = size()
    return n > 1 and cfg.num_kv_heads % n != 0


def _kv_range(cfg) -> tuple[int, int]:
    """(first kv head, kv heads) that this rank's query heads read where
    the kv heads are replicated; raises where they would not be plain GQA
    (each local query head h reading local kv head h // (its group))."""
    n, Hq, Hkv = size(), cfg.num_heads, cfg.num_kv_heads
    nq, G = Hq // n, Hq // Hkv
    r = sharding.current().mesh.axis_index(axis())
    first = r * nq // G
    count = ((r + 1) * nq - 1) // G - first + 1
    if nq % count or any((r * nq + h) // G - first != h // (nq // count)
                         for h in range(nq)):
        raise NotImplementedError(
            f"{cfg.name}: {Hq} query heads and {Hkv} kv heads over {n} model ranks "
            f"give rank {r} kv heads {first}..{first + count - 1} that its query heads "
            "do not read as plain GQA")
    return first, count


def kv_cols(cfg):
    """The columns of a whole ``wk``/``wv`` that this rank projects where the
    kv heads are replicated (a slice: the kv heads its query heads read),
    else None."""
    if not kv_replicated(cfg):
        return None
    first, count = _kv_range(cfg)
    hd = cfg.resolved_head_dim
    return slice(first * hd, (first + count) * hd)


def local_heads(cfg) -> tuple[int, int]:
    """(query heads, kv heads) a rank computes: its ``Hq/tp`` query heads,
    and its ``Hkv/tp`` kv heads or, where they are replicated, the ones its
    query heads read."""
    n = size()
    if kv_replicated(cfg):
        return cfg.num_heads // n, _kv_range(cfg)[1]
    return cfg.num_heads // n, cfg.num_kv_heads // n


def vocab_block(w_out, vocab: int):
    """(mesh, vocab axis, first row) where ``w_out`` (d, V_held) is a rank's
    vocab block of a ``vocab``-row head; None where it is whole."""
    if w_out.shape[-1] == vocab:
        return None
    ctx = sharding.current()
    ax = None if ctx is None else ctx.axes("vocab")
    n = 1 if ax is None else ctx.mesh.axis_size(ax)
    if n == 1 or w_out.shape[-1] * n != vocab:
        raise ValueError(f"a head of {w_out.shape[-1]} columns is neither the "
                         f"{vocab}-token vocabulary nor its block over the vocab axis")
    return ctx.mesh, ax, ctx.mesh.axis_index(ax) * w_out.shape[-1]


def to_head(hidden, w_out, vocab: int):
    """The (B, S, d) hidden states as a vocab-parallel head takes them: the
    backward sums the ranks' partial gradients (an all-reduce), unless SP
    gathered them along the sequence already (whose backward sums)."""
    blk = vocab_block(w_out, vocab)
    if blk is None or seq_parallel():
        return hidden
    return copy(hidden, blk[0], blk[1])


def head_logits(h, w_out, vocab: int, mm=torch.matmul):
    """(B, V) f32 logits of the last positions ``h`` (B, d); a vocab block's
    are all-gathered along the vocabulary (serving: no gradient). ``mm``:
    the product with the head (``fsdp.matmul`` for a held ``lm_head``)."""
    logits = mm(h, w_out).float()
    blk = vocab_block(w_out, vocab)
    if blk is None:
        return logits
    return blk[0].all_gather(logits, blk[1], -1)


def vocab_xent(h, w_out, y, m, blk, mm=torch.matmul):
    """Summed cross-entropy of one chunk over a vocab-parallel head, and its
    weight: h (B, c, d) whole on every rank, ``w_out`` (d, V/n) this rank's
    block (``mm``: the product with it, as ``head_logits``'), labels ``y``
    (B, c), mask ``m``; ``blk`` from ``vocab_block``.
    The max and the sum of exponentials are all-reduced in f32 (the max
    carries no gradient: any constant shifts the log-sum-exp exactly), the
    label's logit comes from the rank that holds it; every rank returns the
    same sum."""
    mesh, ax, base = blk
    logits = mm(h, w_out).float()                             # (B, c, V/n)
    mx = mesh.all_reduce(logits.detach().amax(dim=-1), ax, op="max")
    se = reduce(torch.exp(logits - mx[..., None]).sum(dim=-1), mesh, ax)
    lse = torch.log(se) + mx
    local = y - base
    mine = (local >= 0) & (local < logits.shape[-1])
    ll = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    ll = reduce(torch.where(mine, ll, 0.0), mesh, ax)
    return ((lse - ll) * m).sum(), m.sum()


# the leaves held whole whose every use sees only the rank's part of the
# work: the q/k norms (its heads), mamba's conv and per-channel or per-head
# leaves (its SSD heads' channels), the router (its experts' gates)
_PARTIAL = re.compile(r"(q_norm|k_norm|moe/router"
                      r"|mamba/(?:conv_w|conv_b|norm_w|dt_bias|a_log|d_skip))$")


def partial_leaf(path: str) -> bool:
    """Whether the gradient of the dense leaf at ``path`` is a partial sum
    over the TP axis: a leaf held whole over it that sees only the rank's
    rows (every norm of the stream under SP), heads (q/k norms), SSD heads
    (mamba's conv, ``norm_w``, ``dt_bias``, ``a_log``, ``d_skip``) or
    experts (the router: the gates' part; the load-balancing term's part
    is whole on every rank, and ``models.moe`` counts it once over the
    ranks)."""
    if axis() is None or size() == 1:
        return False
    if _PARTIAL.search(path):
        return True
    if sharding.is_tp_leaf(path) or sharding.is_island_leaf(path):
        return False
    return seq_parallel()
