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


def gather_rows_ref(table, idx):
    """table: (R, D); idx: (N,) ints in [0, R). Returns (N, D) in the
    table's dtype with out[i] = table[idx[i]], bitwise (as the Pallas
    kernel and the JAX oracle ``jnp.take``)."""
    return table.index_select(0, idx.long())


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D), Hq % Hkv == 0.

    Returns (B, Sq, Hq, D) in q's dtype: softmax(q k^T / sqrt(D)) v with the
    scores, the softmax and P.V in f32 and one rounding of the output. q head
    h reads kv head h // (Hq / Hkv) (q's heads viewed as (Hkv, G), no
    repeat). Query row i sits at position ``q_offset + i`` and key j at j;
    ``causal`` masks keys past the query's position with the -1e30 sentinel
    of the Pallas kernel. The JAX oracle takes k, v already expanded to Hq
    heads and masks with -inf; the two agree wherever a row keeps a key.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (1.0 / math.sqrt(D))
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Sk, device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
