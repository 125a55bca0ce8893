"""Sparse in-place row update on the card.

Counterpart of ``scatter_update_pallas`` (``repro/kernels/scatter_update.py``);
the kernel is ``csrc/scatter_update.cu``, whose header says how it is laid
out, what bounds it, and why pad slots carry index -1. Its plain version is
``ref.scatter_update_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches made by scatter_update_cuda


def scatter_update_cuda(table, idx, delta):
    """table[idx[i]] = round(f32(table[idx[i]]) + delta[i]) in place.

    table: (R, D) f32/f16/bf16 on a CUDA device; idx: (N,) int32, each row
    at most once, -1 for a pad slot that is skipped; delta: (N, D) f32.
    Returns ``table``.
    """
    global launches
    if not table.is_cuda:
        raise ValueError("scatter_update_cuda needs a CUDA table")
    if table.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"scatter_update: unsupported table dtype {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("scatter_update: table must be a contiguous (R, D) tensor")
    if idx.device != table.device or idx.dtype != torch.int32 \
            or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("scatter_update: idx must be a contiguous (N,) int32 "
                         "tensor on the table's device")
    n, dim = idx.shape[0], table.shape[1]
    if delta.device != table.device or delta.dtype != torch.float32 \
            or tuple(delta.shape) != (n, dim) or not delta.is_contiguous():
        raise ValueError(f"scatter_update: delta must be a contiguous ({n}, {dim}) "
                         "f32 tensor on the table's device")
    if n >= 2**31:
        raise ValueError(f"scatter_update: {n} slots is too many")
    if n == 0 or dim == 0:
        return table
    _build.launch("scatter_update", table.device,
                  table.data_ptr(), _build.DTYPE_CODES[table.dtype],
                  idx.data_ptr(), delta.data_ptr(), n, dim)
    launches += 1
    return table
