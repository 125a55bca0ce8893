"""Shared model building blocks (counterpart of ``repro.models.layers``).

Params are nested dicts of tensors. Random draws come from an explicit
``torch.Generator`` and land on its device; they cannot reproduce the JAX
package's ``jax.random`` streams, so parity tests load the JAX params
through ``repro_torch.interop``.

Each init takes an optional ``new(shape, dtype)`` that allocates its
leaves (fresh tensors on the generator's device by default); ``Stack``
hands out slices of stacked leaves instead, so that a stack of layers is
drawn in place, never held twice.

Activations are in ``cfg.dtype``; norms (rms and layer), rotary angles
(rope and qwen2-vl's M-RoPE), attention scores and softmax are in f32.
Attention is GQA: prefill and training attention go through the
flash-attention kernels (``ops.flash_attention``, forward and backward),
single-token decode through the plain ``decode_attention``, or under a
``cache_seq`` rule through context-parallel decode over a cache sharded by
sequence (``distributed/context_parallel.py``). A KV cache is updated in
place. Cross-attention (whisper's decoder) takes its K/V as
given and attends to them in full.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed import context_parallel, fsdp, sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map


def layer_params(blocks, num_layers: int) -> list:
    """The stacked block tree as one tree per layer. ``unbind`` gives views
    whose backward stacks the layers' grads once (indexing each layer would
    build a zero tensor of the whole stack per layer)."""
    parts = [a.unbind(0) for a in tree_leaves(blocks)]
    out = []
    for i in range(num_layers):
        it = iter([p[i] for p in parts])
        out.append(tree_map(lambda _, it=it: next(it), blocks))
    return out


def fresh(device):
    """The default leaf allocator: an uninitialised tensor on ``device``."""
    return lambda shape, dtype: torch.empty(shape, dtype=dtype, device=device)


class Stack:
    """Leaf allocator for ``n`` trees of one structure, drawn one after the
    other: leaf k of tree i is slice i of one (n, ...) tensor, allocated
    when tree 0 asks for it. Every tree must ask for its leaves in the same
    order, shapes and dtypes. ``tree(tree0)`` maps tree 0 (its slices) to
    the stacked tree."""

    def __init__(self, n: int, device):
        self.n, self.device, self.leaves, self._base = n, device, [], {}
        self._i = self._k = 0

    def layer(self, i: int):
        """The allocator for tree ``i``."""
        self._i, self._k = i, 0
        return self._new

    def _new(self, shape, dtype):
        shape = tuple(shape)
        if self._i == 0:
            leaf = torch.empty((self.n, *shape), dtype=dtype, device=self.device)
            self.leaves.append(leaf)
        leaf = self.leaves[self._k]
        if leaf.shape[1:] != shape or leaf.dtype != dtype:
            raise ValueError(f"tree {self._i} asked for {shape} {dtype} where "
                             f"tree 0 had {tuple(leaf.shape[1:])} {leaf.dtype}")
        self._k += 1
        view = leaf[self._i]
        if self._i == 0:
            self._base[id(view)] = (view, leaf)
        return view

    def tree(self, tree0):
        return tree_map(lambda v: self._base[id(v)][1], tree0)


def uniform_init(gen: torch.Generator, shape, scale: float, dtype, new=None):
    return (new or fresh(gen.device))(shape, dtype) \
        .uniform_(-scale, scale, generator=gen)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, new=None,
               keep=None, path: str = ""):
    """A (d_in, d_out) uniform draw. With ``keep`` (``sharding.keep_shard``)
    the leaf is drawn whole, as on one rank, and ``keep(path, leaf)``, the
    rank's block of it, is what ``new`` allocates and holds."""
    scale = math.sqrt(1.0 / d_in)
    if keep is None:
        return uniform_init(gen, (d_in, d_out), scale, dtype, new)
    block = keep(path, uniform_init(gen, (d_in, d_out), scale, dtype))
    return block if new is None else new(block.shape, dtype).copy_(block)


def ones(gen: torch.Generator, shape, dtype, new=None):
    return (new or fresh(gen.device))(shape, dtype).fill_(1.0)


def zeros(gen: torch.Generator, shape, dtype, new=None):
    return (new or fresh(gen.device))(shape, dtype).zero_()


# ---------------------------------------------------------------------------
# Norms and rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: int tensor broadcastable to (..., S).

    Rotates the two halves of each head (not interleaved pairs), in f32.
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL's multimodal rope. x: (B, S, H, D); positions3: (3, B, S)
    (temporal, height, width); ``sections`` splits the D/2 frequencies
    among the three, sum(sections) == D // 2. Frequency j turns by the
    position of the section it falls in; in f32, as ``apply_rope``."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    angles = positions3[..., None].float() * freqs            # (3, B, S, D/2)
    bounds = [0]
    for n in sections:
        bounds.append(bounds[-1] + n)
    if bounds[-1] != x.shape[-1] // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not split "
                         f"{x.shape[-1] // 2} frequencies")
    ang = torch.cat([angles[i, ..., lo:hi] for i, (lo, hi)
                     in enumerate(zip(bounds[:-1], bounds[1:], strict=True))], dim=-1)
    cos = torch.cos(ang)[..., None, :]                        # (B, S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(S: int, d: int, *, start: int = 0, device=None):
    """Rows start .. start + S - 1 of the reference's (S', d) sine table:
    sin at the even columns, cos at the odd ones, in f32. Each row is a
    function of its position alone, so a slice is elementwise the table's
    rows (the reference's decoder builds 65,536 rows a call)."""
    pos = (start + torch.arange(S, device=device)).float()[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.zeros((S, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """GQA attention over a whole sequence: one flash-attention call.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D), Hq % Hkv == 0, any batch and
    sequence strides. Query row i sits at position ``q_offset + i`` (the
    reference's ``positions_q``), key j at j. Returns (B, Sq, Hq, D) in q's
    dtype. The reference scans query chunks with a full-KV softmax; the
    kernel tiles both axes itself, so there are no chunk sizes to pass.
    Differentiable: the gradient is the flash backward kernel (the
    reference differentiates its scan, recomputing each query block).
    """
    return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, kv_len):
    """Single-token decode. q: (B, 1, Hq, D); caches: (B, Smax, Hkv, D).

    kv_len: host int, the number of valid cache entries (the new token
    already written). Scores over the whole cache in f32, entries past
    kv_len masked; no kernel (the reference has no Pallas kernel here).
    """
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qf = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float()) / math.sqrt(D)
    mask = torch.arange(Smax, device=q.device) < kv_len   # no transfer, no sync
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def init_attention(gen: torch.Generator, cfg, new=None, keep=None):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.activation_dtype
    p = {name: dense_init(gen, a, b, dt, new, keep, f"attn/{name}")
         for name, a, b in (("wq", d, nq * hd), ("wk", d, nkv * hd),
                            ("wv", d, nkv * hd), ("wo", nq * hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = ones(gen, (hd,), dt, new)
        p["k_norm"] = ones(gen, (hd,), dt, new)
    return p


def attention_fwd(p, cfg, x, positions, *, causal: bool = True, cache=None,
                  cache_index: int | None = None, cross_kv=None,
                  positions3=None):
    """Self-attention with rope and an optional KV cache, or cross-attention.

    x: (B, S, d); positions: (S,) or (B, S) global positions (rope).
    cache: optional dict(k, v) of (B, Smax, Hkv, D), written in place at
    ``cache_index`` (a host int, default 0). With a cache, S == 1 is a
    decode step against the first cache_index + 1 entries; S > 1 attends
    over the cache's first cache_index + S entries, queries at positions
    cache_index .. cache_index + S - 1. ``positions3`` (3, B, S), given
    with ``cfg.mrope_sections``, turns q and k by M-RoPE in place of rope.
    ``cross_kv``: (k, v) of (B, Sk, Hkv, D) to attend to in full (whisper's
    decoder over the encoder's output): no rope, no qk norm on them, no
    cache; S > 1 goes through flash (not causal), S == 1 through the plain
    decode attention over all Sk keys, as in the reference. Returns (out,
    cache).

    Under dense tensor parallelism (``distributed.tensor_parallel``) the
    rank runs its ``Hq/tp`` query heads and the kv heads they read (its
    ``Hkv/tp``, or where ``model`` does not divide the kv heads those of
    the whole wk, wv that its query heads read; local q head h reads local
    kv head h // G, as on one rank), its cache holds those kv heads over
    every position, and the output projection is its row block of wo,
    summed over the ranks; under SP ``x`` is the rank's S/tp rows,
    gathered whole first, and the output is its rows again. Under FSDP
    each projection's held block is gathered at its use (``fsdp.mm``).
    Context-parallel decode (a ``cache_seq`` rule) runs without it.
    """
    x = tp.enter(x)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = tp.local_heads(cfg)

    def out_proj(out):
        return fsdp.row_parallel(out.reshape(B, S, nq * hd), p["wo"], cfg, "attn/wo")
    q = fsdp.mm(x, p["wq"], cfg, "attn/wq").reshape(B, S, nq, hd)
    if cross_kv is not None:
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k, v = cross_kv
        if S == 1:
            out = decode_attention(q, k, v, k.shape[1])
        else:
            out = chunked_attention(q, k, v, causal=False)
        return out_proj(out), cache
    k = fsdp.mm(x, p["wk"], cfg, "attn/wk").reshape(B, S, nkv, hd)
    v = fsdp.mm(x, p["wv"], cfg, "attn/wv").reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.mrope_sections and positions3 is not None:
        q = apply_mrope(q, positions3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions3, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    q_offset = 0
    if cache is not None:
        idx = cache_index or 0
        kc, vc = cache["k"], cache["v"]
        ctx = sharding.current()
        if ctx is not None and ctx.rules.get("cache_seq") and ctx.tp is None:
            # the cache sharded by sequence: context-parallel decode; a
            # prefill (from 0) attends over its own k, v, whole on each rank
            if S == 1:
                out, _, _ = context_parallel.decode_attention_cp(q, kc, vc, k, v, idx)
                return out_proj(out), cache
            context_parallel.write_prefill(cache, k, v, idx)
            out = chunked_attention(q, k, v, causal=causal)
            return out_proj(out), cache
        if idx + S > kc.shape[1]:
            raise ValueError(f"cache of {kc.shape[1]} positions cannot take "
                             f"{S} tokens at {idx}")
        kc[:, idx:idx + S] = k.to(kc.dtype)
        vc[:, idx:idx + S] = v.to(vc.dtype)
        if S == 1:
            out = decode_attention(q, kc, vc, idx + 1)
            return out_proj(out), cache
        k, v, q_offset = kc[:, :idx + S], vc[:, :idx + S], idx
    out = chunked_attention(q, k, v, causal=causal, q_offset=q_offset)
    return out_proj(out), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _check_act(cfg) -> None:
    if cfg.act not in ("silu", "gelu"):
        raise NotImplementedError(f"mlp activation {cfg.act!r} is not ported "
                                  "(the ported MLPs are silu and gelu)")


def init_mlp(gen: torch.Generator, cfg, d_ff=None, new=None, keep=None):
    """SwiGLU MLP params (silu): wi, wg (d, f) and wo (f, d); a gelu MLP
    has wi and wo only. ``keep``: as ``dense_init``'s (the rank's blocks)."""
    _check_act(cfg)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.activation_dtype
    names = (("wi", d, f), ("wo", f, d)) if cfg.act == "gelu" else \
        (("wi", d, f), ("wg", d, f), ("wo", f, d))
    return {name: dense_init(gen, a, b, dt, new, keep, f"mlp/{name}")
            for name, a, b in names}


def mlp_fwd(p, cfg, x):
    """Under dense tensor parallelism wi and wg are the rank's column blocks
    and wo its row block: the stream enters whole (gathered under SP) and
    the output is summed over the ranks (each rank's rows under SP). Under
    FSDP each held block is gathered at its use (``fsdp.mm``)."""
    _check_act(cfg)
    x = tp.enter(x)

    def proj(y, name):
        return fsdp.mm(y, p[name], cfg, f"mlp/{name}")
    if cfg.act == "gelu":   # jax.nn.gelu(approximate=True)
        y = F.gelu(proj(x, "wi"), approximate="tanh")
    else:
        y = F.silu(proj(x, "wg")) * proj(x, "wi")
    return fsdp.row_parallel(y, p["wo"], cfg, "mlp/wo")


# ---------------------------------------------------------------------------
# Cross-entropy, chunked over tokens
# ---------------------------------------------------------------------------


def _chunk_xent(h, w_out, y, m, mm=torch.matmul):
    """Summed cross-entropy of one chunk and its weight; logits in f32."""
    logits = mm(h, w_out).float()                         # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, y[..., None])[..., 0]
    return ((lse - ll) * m).sum(), m.sum()


def chunked_softmax_xent(hidden, w_out, labels, *, chunk: int = 8192,
                         mask=None, vocab: int | None = None, mm=None):
    """Cross-entropy without materialising (tokens x vocab) logits.

    hidden: (B, S, d); w_out: (d, V); labels: (B, S) ints; mask optional
    (B, S). Walks sequence chunks; each chunk's logits are f32. Returns
    (sum_loss, sum_weight) as f32 scalars. Differentiable: with grad on,
    each chunk runs under ``torch.utils.checkpoint``, so its logits are
    recomputed in the backward and never saved, as the reference's
    ``jax.checkpoint`` per chunk does (``src/repro/models/layers.py:341``).
    ``vocab``: the global vocabulary; where ``w_out`` is a rank's block of
    it the head is vocab-parallel (``tensor_parallel.vocab_xent``), and
    ``hidden`` must come through ``tensor_parallel.to_head``. ``mm``: the
    product with ``w_out`` (default ``h @ w_out``; ``fsdp.matmul`` for a
    held ``lm_head``, gathered in each chunk and its recompute).
    """
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    recompute = torch.is_grad_enabled() and (hidden.requires_grad
                                             or w_out.requires_grad)
    blk = None if vocab is None else tp.vocab_block(w_out, vocab)
    mm = mm or torch.matmul
    fn = (lambda h, w, y, m: _chunk_xent(h, w, y, m, mm)) if blk is None else \
        (lambda h, w, y, m: tp.vocab_xent(h, w, y, m, blk, mm))
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, min(chunk, S)):
        args = (hidden[:, s0:s0 + chunk], w_out, labels[:, s0:s0 + chunk].long(),
                mask[:, s0:s0 + chunk].float())
        if recompute:
            li, ci = torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        else:
            li, ci = fn(*args)
        loss = loss + li
        count = count + ci
    return loss, count
