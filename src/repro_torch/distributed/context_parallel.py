"""Context-parallel decode: the KV cache sharded along the sequence
(counterpart of ``repro.distributed.context_parallel``).

Under a ``cache_seq`` rule each rank holds ``Smax / n`` cache positions,
block i of n on the rank whose linear index over the rule's axes is i. A
decode step's softmax over the sharded positions needs the two-pass
max/sum combine:

    local:  m_i = max_j s_ij ; l_i = sum exp(s-m) ; o_i = sum exp(s-m) v
    global: m* = max over ranks (m);  o = sum(o_i e^{m_i-m*}) / sum(l_i e^{m_i-m*})

in f32, the maximum and the two sums ``all_reduce``d over the rule's axes.
The new K/V row is written by the rank that owns position ``pos`` alone.

A prefill writes each rank's part of its positions (``write_prefill``);
it attends over its own projected K/V, whole on every rank, so it needs
no collective. A prefill at ``cache_index > 0`` would need the cache's
filled prefix gathered: it raises (the serve loop prefills once, at 0).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding


def cache_axes(ctx=None):
    """The mesh axes the current ``cache_seq`` rule shards the cache over,
    as a tuple (empty: no rule, or none of its axes in the mesh, or a
    ``heads`` rule: under dense tensor parallelism a cache holds the rank's
    kv heads over every position, where the reference's decode rules name
    both, ROADMAP section 3; jamba's ``context_parallel_decode`` profile
    serves so too, its mamba states holding the rank's SSD heads)."""
    ctx = ctx or sharding.current()
    if ctx is None or ctx.tp is not None:
        return ()
    ax = ctx.axes("cache_seq")
    return () if ax is None else ((ax,) if isinstance(ax, str) else tuple(ax))


def local_positions(max_seq: int) -> int:
    """The cache positions a rank holds of ``max_seq`` under the current
    rule (``max_seq`` without one); raises where the ranks do not divide
    it."""
    axes = cache_axes()
    if not axes:
        return max_seq
    n = sharding.current().mesh.axis_size(axes)
    if max_seq % n:
        raise ValueError(f"a cache of {max_seq} positions does not split over "
                         f"the {n} ranks of cache_seq {axes}")
    return max_seq // n


def _check_fits(ctx, axes, S_loc: int, idx: int, S: int) -> None:
    total = S_loc * ctx.mesh.axis_size(axes)
    if idx + S > total:
        raise ValueError(f"cache of {total} positions cannot take {S} tokens at {idx}")


def write_prefill(cache, k, v, idx: int):
    """Writes the new (B, S, Hkv, D) ``k``, ``v`` at positions ``idx ..
    idx + S - 1`` of a cache sharded by sequence: each rank the part it
    holds. Only a prefill from position 0 is taken."""
    if idx != 0:
        raise NotImplementedError(
            f"a prefill at cache_index {idx} under a cache_seq rule would attend "
            "over the cache's filled prefix, which each rank holds only in part; "
            "prefill from 0 (context-parallel decode then continues it)")
    ctx = sharding.current()
    axes = cache_axes(ctx)
    kc, vc = cache["k"], cache["v"]
    S, S_loc = k.shape[1], kc.shape[1]
    _check_fits(ctx, axes, S_loc, idx, S)
    base = ctx.mesh.axis_index(axes) * S_loc
    lo, hi = max(idx, base), min(idx + S, base + S_loc)
    if lo < hi:
        kc[:, lo - base:hi - base] = k[:, lo - idx:hi - idx].to(kc.dtype)
        vc[:, lo - base:hi - base] = v[:, lo - idx:hi - idx].to(vc.dtype)


def decode_attention_cp(q, k_cache, v_cache, new_k, new_v, pos: int):
    """q/new_k/new_v: (B, 1, H*, D); the caches: this rank's (B, Smax/n,
    Hkv, D) part, written in place; ``pos`` a host int.

    Requires an active sharding context with rules["cache_seq"] set.
    Returns (attn_out, k_cache, v_cache).
    """
    ctx = sharding.current()
    axes = cache_axes(ctx)
    mesh = ctx.mesh
    B, S_loc, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    _check_fits(ctx, axes, S_loc, pos, 1)
    base = mesh.axis_index(axes) * S_loc
    off = pos - base
    if 0 <= off < S_loc:
        k_cache[:, off] = new_k[:, 0].to(k_cache.dtype)
        v_cache[:, off] = new_v[:, 0].to(v_cache.dtype)

    qf = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float()) / math.sqrt(D)
    valid = (base + torch.arange(S_loc, device=q.device)) <= pos     # (S_loc,)
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(dim=-1)                                                # (B,Hkv,G)
    p = torch.exp(s - m[..., None])
    denom = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())

    m_g = mesh.all_reduce(m, axes, op="max")
    alpha = torch.exp(m - m_g)
    l_g = mesh.all_reduce(denom * alpha, axes)
    o_g = mesh.all_reduce(o * alpha[..., None], axes)
    out = (o_g / torch.clamp(l_g, min=1e-30)[..., None]).reshape(B, 1, Hq, D)
    return out.to(q.dtype), k_cache, v_cache
