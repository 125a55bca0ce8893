"""Plain PyTorch versions of the port's kernels (counterpart of ``repro.kernels.ref``).

They run wherever torch runs. The CPU path uses them, and the kernels are
held against them on the card. They compute with the port's arithmetic,
which is where they differ from the JAX oracles (see each docstring).
"""
from __future__ import annotations

import math

import torch


def embedding_bag_ref(table, idx, seg, num_bags: int):
    """table: (R, D); idx, seg: (N,), seg non-decreasing bag ids.

    Returns (num_bags, D) f32 with out[b] = sum_{i: seg[i] == b} table[idx[i]],
    the rows converted to f32 before they are summed (the JAX oracle sums in
    the table's dtype).
    """
    rows = table.index_select(0, idx.long()).float()
    out = torch.zeros((num_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    return out.index_add_(0, seg.long(), rows)


def scatter_update_ref(table, idx, delta):
    """In place: table[idx[i]] = round(f32(table[idx[i]]) + f32(delta[i])).

    idx: (N,) with each row at most once; slots holding -1 are pads and are
    skipped. Returns ``table``. This is the trainer's update arithmetic
    (``repro/core/relaxed.py:91-95``). The JAX oracle instead casts delta to
    the table's dtype before the add; the two agree for f32 tables and
    differ in the last bit for bf16 and f16 ones.
    """
    keep = idx >= 0
    rows = idx[keep].long()
    table[rows] = (table[rows].float() + delta[keep].float()).to(table.dtype)
    return table


def scatter_update_logged_ref(table, idx, delta):
    """``scatter_update_ref`` with undo capture. Returns ``(table, old)``:
    old (N, D) in the table's dtype holds the rows idx[i] as they were
    before the update, bitwise, and +0 in a pad slot (-1). The JAX oracle
    pads with row 0 and logs row 0's content there instead.
    """
    keep = idx >= 0
    old = torch.zeros((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    old[keep] = table[idx[keep].long()]
    return scatter_update_ref(table, idx, delta), old


def gather_rows_ref(table, idx):
    """table: (R, D); idx: (N,) ints in [0, R). Returns (N, D) in the
    table's dtype with out[i] = table[idx[i]], bitwise (as the Pallas
    kernel and the JAX oracle ``jnp.take``)."""
    return table.index_select(0, idx.long())


def _attention_scores(q, k, causal: bool, q_offset: int):
    """f32 scores q k^T / sqrt(D) of shape (B, Hkv, G, Sq, Sk), masked keys
    at -1e30, and the mask itself (True where a key is masked, or None)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (1.0 / math.sqrt(D))
    masked = None
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Sk, device=q.device)
        masked = q_pos[:, None] < k_pos[None, :]
        s = s.masked_fill(masked, -1e30)
    return s, masked


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        return_lse: bool = False, p_dtype=None, p_terms: int = 2):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D), Hq % Hkv == 0.

    Returns (B, Sq, Hq, D) in q's dtype: softmax(q k^T / sqrt(D)) v with the
    scores, the softmax and P.V in f32 and one rounding of the output. q head
    h reads kv head h // (Hq / Hkv) (q's heads viewed as (Hkv, G), no
    repeat). Query row i sits at position ``q_offset + i`` and key j at j;
    ``causal`` masks keys past the query's position with the -1e30 sentinel
    of the Pallas kernel. The JAX oracle takes k, v already expanded to Hq
    heads and masks with -inf; the two agree wherever a row keeps a key.

    With ``return_lse`` also returns each row's log-sum-exp of the scaled
    scores, f32 of shape (B, Hq, Sq): what the backward needs to rebuild P.

    ``p_dtype`` (a 16-bit dtype, default None: P in f32) emulates a kernel
    that multiplies P.V with P in that type: P = exp(S - max) is carried as
    ``p_terms`` terms of it, each the rounding of what the earlier ones
    leave (2: P_hi = round(P) and P_lo = round(P - P_hi), the tensor-core
    forward's split; 1: a single rounding), and the sum of the terms' f32
    products with v is divided by the unrounded row sum.
    """
    B, Sq, Hq, D = q.shape
    s, _ = _attention_scores(q, k, causal, q_offset)
    if p_dtype is None:
        p = torch.softmax(s, dim=-1)
    else:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        rest, p = e, torch.zeros_like(e)
        for _ in range(p_terms):
            term = rest.to(p_dtype).float()
            p, rest = p + term, rest - term
        p = p / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o.reshape(B, Sq, Hq, D).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            q_offset: int = 0, round_to=None):
    """The backward of ``flash_attention_ref``, written out (no autograd).

    q, o, do: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); lse: (B, Hq, Sq) f32,
    the forward's row log-sum-exp. In f32, per (batch, q head), with the
    scores S = q k^T / sqrt(D) masked as in the forward:

        P = exp(S - lse)    dV = P^T dO    dP = dO V^T
        Delta = rowsum(dO * O)    dS = P * (dP - Delta)
        dQ = dS K / sqrt(D)    dK = dS^T Q / sqrt(D)

    dK and dV of a kv head sum the G q heads that read it. Delta reads the
    forward's stored (rounded) output, as the kernel does. Returns (dq, dk,
    dv) in q's, k's and v's dtypes.

    ``round_to`` (a 16-bit dtype, default None: all in f32) emulates the
    tensor-core kernel's arithmetic: P is rounded to it before dV = P^T dO,
    and dS before dQ and dK; dS itself is formed from the unrounded P.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    s, masked = _attention_scores(q, k, causal, q_offset)
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq)[..., None])
    if masked is not None:
        p = p.masked_fill(masked, 0.0)
    dof = do.float().reshape(B, Sq, Hkv, G, D)
    qf = q.float().reshape(B, Sq, Hkv, G, D)

    def rounded(x):
        return x if round_to is None else x.to(round_to).float()
    dv = torch.einsum("bkgqs,bqkgd->bskd", rounded(p), dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    delta = (dof * o.float().reshape(B, Sq, Hkv, G, D)).sum(-1)   # (B, Sq, Hkv, G)
    ds = rounded(p * (dp - delta.permute(0, 2, 3, 1)[..., None]))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


WKV6_CHUNK = 16   # rows per wkv6 chunk: fixed, the CUDA kernel's kC


def _tf32(x):
    """x (f32) rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the card's ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """x (f32) cut to TF32, its low 13 bits dropped, as the tensor cores
    read a TF32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_product(eq, a, b, tf32):
    """``torch.einsum(eq, a, b)`` with the operands rounded as the wkv6
    kernel's tensor cores take them: ``"single"`` one TF32 rounding of
    each; ``"split"`` each as hi + lo, hi rounded to TF32 and lo = x - hi
    cut to TF32, and the three products hi hi + (hi lo + lo hi) summed in
    f32 (lo lo is dropped)."""
    if tf32 == "single":
        return torch.einsum(eq, _tf32(a), _tf32(b))
    if tf32 != "split":
        raise ValueError(f"tf32 must be None, 'split' or 'single', got {tf32!r}")
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return torch.einsum(eq, ah, bh) + (torch.einsum(eq, ah, bl)
                                       + torch.einsum(eq, al, bh))


def wkv6_ref(r, k, v, logw, u, s0=None, *, s_out=None, tf32=None):
    """Chunked RWKV-6 time-mix (``wkv6_chunked`` of the JAX model, in torch).

    r, k, v: (B, S, H, K) in the activation dtype; logw: (B, S, H, K) f32,
    the per-step log decay, already clamped to [LOG_W_MIN, -1e-4]; u: (H, K)
    f32, the bonus of the current token; s0: (B, H, K, K) f32 initial state,
    or None for zero. Per head, with w_t = exp(logw_t):

        y_t = r_t (diag(u) k_t^T v_t + S_{t-1});  S_t = diag(w_t) S_{t-1} + k_t^T v_t

    Returns (y (B, S, H, K) f32, s_fin (B, H, K, K) f32); with ``s_out`` the
    final state is copied into it (it may be s0 itself) and it is returned.

    The sequence runs in chunks of ``WKV6_CHUNK`` (16) rows from the start,
    the last one shorter if S is not a multiple (here: zero rows appended,
    which add nothing to the state and leave the decay to the chunk's end as
    it is), the grouping the CUDA kernel uses. Within a chunk the scores are
    the factorised (r e^{L_excl}) (k e^{-L_incl})^T, which stays inside f32
    only because logw >= -5 and a chunk has at most 16 rows (exponents up
    to 80); so the chunk is fixed, not a parameter. The JAX function instead
    picks the largest divisor of S that is at most 16, so the two agree only
    within rounding where the groupings differ.

    ``tf32`` (tests only) emulates the CUDA kernel's arithmetic: the bonus
    sits on the scores' diagonal, the state's decay to the chunk's end is
    k_f e^{L_end}, and the four products (the scores r_f k_f^T, their
    product with v, r_f S_prev, the chunk's k^T v) take their operands
    rounded to TF32, split in two terms (``"split"``, the kernel's) or once
    (``"single"``, which the kernel does not do); see ``_tf32_product``.
    """
    B, S, H, K = r.shape
    chunk = WKV6_CHUNK
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(x):
        x = x.float()
        if pad:
            x = torch.cat([x, x.new_zeros((B, pad, H, K))], dim=1)
        return x.reshape(B, nc, chunk, H, K)

    def product(eq, a, b):
        if tf32 is None:
            return torch.einsum(eq, a, b)
        return _tf32_product(eq, a, b, tf32)
    rc, kc, vc, lw = (chunks(x) for x in (r, k, v, logw))
    cum_incl = torch.cumsum(lw, dim=2)                  # includes step t
    cum_excl = cum_incl - lw
    r_f = rc * torch.exp(cum_excl)
    k_f = kc * torch.exp(-cum_incl)
    scores = product("bnthk,bnjhk->bnhtj", r_f, k_f)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    scores = scores.masked_fill(~mask, 0.0)             # strictly lower
    bonus = torch.einsum("bnthk,hk,bnthk->bnth", rc, u.float(), kc)
    chunk_dec = torch.exp(cum_incl[:, :, -1])           # (B, nc, H, K)
    if tf32 is None:
        y = torch.einsum("bnhtj,bnjhk->bnthk", scores, vc)
        y = y + bonus[..., None] * vc
        # each chunk's own contribution to the state at its end
        kd = kc * torch.exp(cum_incl[:, :, -1:] - cum_incl)
    else:
        scores = scores + torch.diag_embed(bonus.permute(0, 1, 3, 2))
        y = product("bnhtj,bnjhk->bnthk", scores, vc)
        kd = k_f * chunk_dec[:, :, None]
    st_c = product("bnjhk,bnjhw->bnhkw", kd, vc)
    s = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    s_prev = []
    for n in range(nc):
        s_prev.append(s)
        s = s * chunk_dec[:, n, :, :, None] + st_c[:, n]
    y = y + product("bnthk,bnhkw->bnthw", r_f, torch.stack(s_prev, dim=1))
    y = y.reshape(B, nc * chunk, H, K)[:, :S]
    if s_out is not None:
        s = s_out.copy_(s)
    return y, s


def wkv6_bwd_ref(r, k, v, logw, u, s0, dy, ds_fin=None, *, tf32=None):
    """The backward of ``wkv6_ref`` (f32 route), written out (no autograd).

    r, k, v, logw, u, s0 as ``wkv6_ref`` takes them; dy (B, S, H, K), the
    gradient of y; ds_fin (B, H, K, K) that of the final state, or None for
    zero. Over the same 16-row chunks from the start, with L the cumulative
    log decay within a chunk, r_f = r e^{L_excl}, k_f = k e^{-L_incl}, kd =
    k e^{L_end - L_incl}, A = tril(r_f k_f^T, -1) and G_n the gradient of
    the state after chunk n (G_last = ds_fin):

        G_{n-1} = diag(e^{L_end}) G_n + r_f^T dy      (the reverse walk)
        dkd = v G^T    dv = A^T dy + (r u k) dy + kd G
        dA = tril(dy v^T, -1)   dr_f = dA k_f + dy S_prev^T   dk_f = dA^T r_f
        dr = dr_f e^{L_excl} + (dy.v) u k    dk = dk_f e^{-L_incl} + dkd
             e^{L_end - L_incl} + (dy.v) u r

    and dlogw from dL_excl = dr_f r_f, dL_incl = -dk_f k_f - dkd kd (plus,
    at the chunk's last row, dL_end = e^{L_end} sum_w S_prev G + sum_j dkd
    kd) by a reverse cumulative sum down the chunk, less dL_excl.

    Returns (dr, dk, dv, dlogw) of (B, S, H, K), du (H, K) summed over
    batch and time, and ds0 (B, H, K, K), None when s0 is None; all f32
    (the caller casts dr, dk, dv to the inputs' dtype).

    ``tf32`` (tests only) emulates the CUDA kernel's arithmetic: the bonus
    sits on the scores' diagonal for dv, and every product the kernel takes
    on the tensor cores (the state's recompute kd^T v, the scores, dA,
    r_f^T dy, v G^T, kd G, A^T dy, dA k_f, dy S_prev^T, dA^T r_f) takes its
    operands rounded to TF32, split in two terms (``"split"``, the
    kernel's) or once (``"single"``); see ``_tf32_product``.
    """
    B, S, H, K = r.shape
    chunk = WKV6_CHUNK
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(x):
        x = x.float()
        if pad:
            x = torch.cat([x, x.new_zeros((B, pad, H, K))], dim=1)
        return x.reshape(B, nc, chunk, H, K)

    def unchunk(x):
        return x.reshape(B, nc * chunk, H, K)[:, :S]

    def product(eq, a, b):
        if tf32 is None:
            return torch.einsum(eq, a, b)
        return _tf32_product(eq, a, b, tf32)
    rc, kc, vc, lw, dyc = (chunks(x) for x in (r, k, v, logw, dy))
    u = u.float()
    cum_incl = torch.cumsum(lw, dim=2)
    e_excl = torch.exp(cum_incl - lw)
    e_nincl = torch.exp(-cum_incl)
    r_f, k_f = rc * e_excl, kc * e_nincl
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    scores = product("bnthk,bnjhk->bnhtj", r_f, k_f).masked_fill(~lower, 0.0)
    bonus = torch.einsum("bnthk,hk,bnthk->bnth", rc, u, kc)
    l_end = cum_incl[:, :, -1]                          # (B, nc, H, K)
    chunk_dec = torch.exp(l_end)
    e_kd = torch.exp(l_end[:, :, None] - cum_incl)
    kd = kc * e_kd
    st_c = product("bnjhk,bnjhw->bnhkw", kd, vc)
    s = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    s_prev = []
    for n in range(nc):
        s_prev.append(s)
        s = s * chunk_dec[:, n, :, :, None] + st_c[:, n]
    s_prev = torch.stack(s_prev, dim=1)                 # (B, nc, H, K, K)
    rdy = product("bnthk,bnthw->bnhkw", r_f, dyc)
    g = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
         if ds_fin is None else ds_fin.float())
    g_after = [None] * nc
    for n in reversed(range(nc)):
        g_after[n] = g
        g = g * chunk_dec[:, n, :, :, None] + rdy[:, n]
    ds0 = None if s0 is None else g
    G = torch.stack(g_after, dim=1)                     # (B, nc, H, K, K)
    d_kd = product("bnjhw,bnhkw->bnjhk", vc, G)
    d_lend = chunk_dec * torch.einsum("bnhkw,bnhkw->bnhk", s_prev, G) \
        + (d_kd * kd).sum(2)
    d_scores = product("bnthw,bnjhw->bnhtj", dyc, vc).masked_fill(~lower, 0.0)
    d_bonus = (dyc * vc).sum(-1)                        # (B, nc, chunk, H)
    if tf32 is None:
        dv = (torch.einsum("bnjhk,bnhkw->bnjhw", kd, G)
              + torch.einsum("bnhtj,bnthw->bnjhw", scores, dyc)
              + bonus[..., None] * dyc)
    else:
        scores = scores + torch.diag_embed(bonus.permute(0, 1, 3, 2))
        dv = (product("bnhtj,bnthw->bnjhw", scores, dyc)
              + product("bnjhk,bnhkw->bnjhw", kd, G))
    d_rf = (product("bnhtj,bnjhk->bnthk", d_scores, k_f)
            + product("bnthw,bnhkw->bnthk", dyc, s_prev))
    d_kf = product("bnhtj,bnthk->bnjhk", d_scores, r_f)
    ub = d_bonus[..., None] * u
    dr = d_rf * e_excl + ub * kc
    dk = d_kf * e_nincl + d_kd * e_kd + ub * rc
    du = (d_bonus[..., None] * rc * kc).sum((0, 1, 2))
    d_excl = d_rf * r_f
    d_incl = d_excl - d_kf * k_f - d_kd * kd
    d_incl[:, :, -1] += d_lend
    dlw = torch.flip(torch.cumsum(torch.flip(d_incl, [2]), dim=2), [2]) - d_excl
    return (unchunk(dr), unchunk(dk), unchunk(dv), unchunk(dlw), du, ds0)


def mamba_ssd_ref(xh, dt, a, B_, C_):
    """Sequential oracle for the mamba layer's chunked SSD scan (the
    reference's ``ref.mamba_ssd_ref``; no kernel: only tests use it).

    xh: (B, S, H, P); dt: (B, S, H); a: (H,); B_, C_: (B, S, N).
    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T;  y_t = C_t . h_t, from
    h_0 = 0, in f32. Returns (y (B, S, H, P), h_final (B, H, N, P)).
    """
    Bb, S, H, P = xh.shape
    N = B_.shape[-1]
    xh, dt, B_, C_ = (t.float() for t in (xh, dt, B_, C_))
    h = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(S):
        dec = torch.exp(dt[:, t] * a[None])                       # (B,H)
        upd = torch.einsum("bm,bhp->bhmp", B_[:, t], xh[:, t] * dt[:, t, :, None])
        h = h * dec[..., None, None] + upd
        ys.append(torch.einsum("bm,bhmp->bhp", C_[:, t], h))
    return torch.stack(ys, dim=1), h
