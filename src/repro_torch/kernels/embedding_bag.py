"""Embedding bag on the card: fused gather and segment sum.

Counterpart of ``embedding_bag_pallas`` (``repro/kernels/embedding_bag.py``);
the kernel is ``csrc/embedding_bag.cu``, whose header says how it is laid
out and what bounds it. Its plain version is ``ref.embedding_bag_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches made by embedding_bag_cuda


def embedding_bag_cuda(table, idx, seg, num_bags: int):
    """out[b] = sum_{i: seg[i] == b} table[idx[i]] in f32; empty bags are 0.

    table: (R, D) f32/f16/bf16 on a CUDA device; idx, seg: (N,) int32 on the
    same device, seg non-decreasing with values in [0, num_bags), idx in
    [0, R). Returns (num_bags, D) f32. Items are summed in order within a
    bag, so the result is the same on every run.
    """
    global launches
    if not table.is_cuda:
        raise ValueError("embedding_bag_cuda needs a CUDA table")
    if table.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"embedding_bag: unsupported table dtype {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("embedding_bag: table must be a contiguous (R, D) tensor")
    for name, t in (("idx", idx), ("seg", seg)):
        if t.device != table.device or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"embedding_bag: {name} must be a contiguous "
                             "(N,) int32 tensor on the table's device")
    if idx.shape != seg.shape:
        raise ValueError(f"embedding_bag: idx {tuple(idx.shape)} and seg "
                         f"{tuple(seg.shape)} differ")
    if not 0 <= num_bags < 2**31:
        raise ValueError(f"embedding_bag: num_bags {num_bags} out of range")
    dim = table.shape[1]
    out = torch.empty((num_bags, dim), dtype=torch.float32, device=table.device)
    if num_bags == 0 or dim == 0:
        return out
    # CSR offsets: bag b owns items offsets[b] .. offsets[b + 1] - 1
    bounds = torch.arange(num_bags + 1, dtype=torch.int32, device=table.device)
    offsets = torch.searchsorted(seg, bounds, out_int32=True)
    _build.launch("embedding_bag", table.device,
                  table.data_ptr(), _build.DTYPE_CODES[table.dtype],
                  idx.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                  num_bags, dim)
    launches += 1
    return out
