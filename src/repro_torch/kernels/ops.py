"""Kernel dispatch by device (counterpart of ``repro.kernels.ops``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version in ``ref``; any other device raises. There is no switch that could
send a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gather_rows as gr
from repro_torch.kernels import ref
from repro_torch.kernels import scatter_update as su
from repro_torch.kernels import wkv6 as wk


def _plain_ok(t, op: str) -> None:
    if t.device.type != "cpu":
        raise RuntimeError(f"{op}: no kernel for device {t.device}")


def embedding_bag(table, idx, seg, num_bags: int):
    """Fused gather + segment sum -> (num_bags, D) f32. idx/seg (N,) int32,
    seg non-decreasing; empty bags are zero."""
    if table.is_cuda:
        return eb.embedding_bag_cuda(table, idx, seg, num_bags)
    _plain_ok(table, "embedding_bag")
    return ref.embedding_bag_ref(table, idx, seg, num_bags)


def gather_rows(table, idx):
    """out[i] = table[idx[i]] -> (N, D) in the table's dtype, bitwise;
    idx (N,) int32 in [0, R), no pads."""
    if table.is_cuda:
        return gr.gather_rows_cuda(table, idx)
    _plain_ok(table, "gather_rows")
    return ref.gather_rows_ref(table, idx)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Attention, (B, Sq, Hq, D) x (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's
    dtype, f32 inside; GQA by head index; query row i at position
    ``q_offset + i``. Differentiable: when grad is on and an input needs
    it, the call goes through ``FlashAttention``, whose backward is the
    backward kernel (or its plain version on the CPU)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return fa.FlashAttention.apply(q, k, v, causal, q_offset)
    if q.is_cuda:
        return fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    _plain_ok(q, "flash_attention")
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)


def flash_attention_lse(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """``flash_attention`` (not differentiable) that also returns each row's
    log-sum-exp, (B, Hq, Sq) f32: the forward that training saves."""
    if q.is_cuda:
        return fa.flash_attention_cuda(q, k, v, causal=causal,
                                       q_offset=q_offset, want_lse=True)
    _plain_ok(q, "flash_attention")
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   return_lse=True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention`` from its inputs, output o,
    log-sum-exp and the output's gradient do (contiguous on the card)."""
    if q.is_cuda:
        return fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                           q_offset=q_offset)
    _plain_ok(q, "flash_attention_bwd")
    return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       q_offset=q_offset)


def wkv6(r, k, v, logw, u, s0=None, *, s_out=None):
    """Chunked RWKV-6 time-mix: r, k, v (B, S, H, 64), logw (B, S, H, 64)
    f32, u (H, 64) f32, s0 (B, H, 64, 64) f32 or None -> (y (B, S, H, 64)
    f32, final state); ``s_out`` receives the final state (it may be s0).
    Differentiable: when grad is on and an input needs it, the call goes
    through ``WKV6``, whose backward is the backward kernel (or its plain
    version on the CPU); such a call takes no ``s_out``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, logw, u, s0)):
        if s_out is not None:
            raise ValueError("wkv6: a differentiable call returns its final "
                             "state and writes no s_out")
        return wk.WKV6.apply(r, k, v, logw, u, s0)
    if r.is_cuda:
        return wk.wkv6_cuda(r, k, v, logw, u, s0, s_out=s_out)
    _plain_ok(r, "wkv6")
    return ref.wkv6_ref(r, k, v, logw, u, s0, s_out=s_out)


def wkv6_bwd(r, k, v, logw, u, s0, dy, ds_fin=None):
    """Gradients of ``wkv6`` from its inputs, dy (B, S, H, 64) f32 and
    ds_fin (B, H, 64, 64) f32 or None: (dr, dk, dv) in r's dtype, dlogw
    f32, du (H, 64) f32 and ds0 (None when s0 is None)."""
    if r.is_cuda:
        return wk.wkv6_bwd_cuda(r, k, v, logw, u, s0, dy, ds_fin)
    _plain_ok(r, "wkv6_bwd")
    dr, dk, dv, dlogw, du, ds0 = ref.wkv6_bwd_ref(r, k, v, logw, u, s0, dy, ds_fin)
    return dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dlogw, du, ds0


def scatter_update(table, idx, delta):
    """table rows at unique idx += delta (f32), in place; idx -1 is skipped."""
    if table.is_cuda:
        return su.scatter_update_cuda(table, idx, delta)
    _plain_ok(table, "scatter_update")
    return ref.scatter_update_ref(table, idx, delta)


def scatter_update_logged(table, idx, delta):
    """``scatter_update`` that also returns the undo image: ``(table, old)``,
    old (N, D) in the table's dtype with the pre-update rows at idx, bitwise,
    and +0 for a pad (-1) slot."""
    if table.is_cuda:
        return su.scatter_update_logged_cuda(table, idx, delta)
    _plain_ok(table, "scatter_update_logged")
    return ref.scatter_update_logged_ref(table, idx, delta)


def combine_duplicates(idx, delta, item_rows=None):
    """Sum the deltas of duplicate indices, in a fixed order.

    idx: (N,) int32. Item i's delta is ``delta[item_rows[i]]``, or
    ``delta[i]`` when ``item_rows`` is None (the DLRM adjoint passes the
    bag of each item, so the (N, D) repeat is never built).

    Returns ``(uniq_idx, combined)`` of static shape (N,) int32 and (N, D)
    f32: slot s holds the s-th smallest distinct index and the sum of its
    deltas in item order. Slots past the last distinct index hold -1 and a
    zero delta; the update kernels skip them. (The JAX version pads with row
    0 instead, which only a sequential update tolerates.) The sum is the
    embedding-bag kernel over the sorted items, so it is the same on every
    run, where ``index_add_`` on the card is not.
    """
    n = idx.shape[0]
    sorted_idx, order = torch.sort(idx, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = sorted_idx[1:] != sorted_idx[:-1]
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
    uniq = torch.full((n,), -1, dtype=torch.int32, device=idx.device)
    uniq.scatter_(0, seg.long(), sorted_idx)
    src = order if item_rows is None else item_rows[order]
    return uniq, embedding_bag(delta, src.to(torch.int32), seg, n)
