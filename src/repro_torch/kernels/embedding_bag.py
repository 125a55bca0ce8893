"""Embedding bag on the card: fused gather and segment sum.

Counterpart of ``embedding_bag_pallas`` (``repro/kernels/embedding_bag.py``);
the kernel is ``csrc/embedding_bag.cu``, whose header says how it is laid
out and what bounds it. Its plain version is ``ref.embedding_bag_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches made by embedding_bag_cuda
PASSES = 2     # launches per call with items: bags and runs, then long bags
WHOLE = 80     # a bag of at most this many items is summed whole (kWhole)
RUN = 32       # a longer bag is summed in runs of this many items (kRun)


def embedding_bag_cuda(table, idx, seg, num_bags: int):
    """out[b] = sum_{i: seg[i] == b} table[idx[i]] in f32; empty bags are 0.

    table: (R, D) f32/f16/bf16 on a CUDA device; idx, seg: (N,) int32 on the
    same device, seg non-decreasing with values in [0, num_bags), idx in
    [0, R). Returns (num_bags, D) f32. A bag of at most ``WHOLE`` items is
    summed in item order; a longer one in runs of ``RUN`` items, each in
    item order, then the runs in order. So the result is the same on every
    run. ``PASSES`` launches (one when N is 0); the kernel finds each bag's
    items by binary search over seg.
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
    n, dim = idx.shape[0], table.shape[1]
    out = torch.empty((num_bags, dim), dtype=torch.float32, device=table.device)
    if num_bags == 0 or dim == 0:
        return out
    # scratch: two run sums and a long bag's (bag, first item, count) per
    # window of RUN items
    n_win = -(-n // RUN)
    partial = torch.empty((2 * n_win, dim), dtype=torch.float32, device=table.device)
    desc = torch.empty((n_win, 3), dtype=torch.int32, device=table.device)
    for p in range(PASSES if n else 1):
        _build.launch("embedding_bag", table.device, p, table.data_ptr(),
                      _build.DTYPE_CODES[table.dtype], idx.data_ptr(),
                      seg.data_ptr(), out.data_ptr(), partial.data_ptr(),
                      desc.data_ptr(), n, num_bags, dim)
        launches += 1
    return out
