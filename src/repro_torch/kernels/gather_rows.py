"""Row gather on the card.

Counterpart of ``gather_rows_pallas`` (``repro/kernels/embedding_bag.py``);
the kernel is ``csrc/gather_rows.cu``, whose header says how it is laid
out and what bounds it. Its plain version is ``ref.gather_rows_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches made by gather_rows_cuda
wide_launches = 0     # those that moved 16-byte chunks
narrow_launches = 0   # those that moved narrower chunks


def chunk_bytes(row_bytes: int, *ptrs: int) -> int:
    """Bytes a thread moves at once: the largest of 16, 8, 4, 2 and 1 that
    divides the row's bytes and every base address (table and output)."""
    align = row_bytes
    for p in ptrs:
        align |= p
    return next(c for c in (16, 8, 4, 2, 1) if align % c == 0)


def gather_rows_cuda(table, idx):
    """out[i] = table[idx[i]], bitwise.

    table: (R, D) of any dtype on a CUDA device, contiguous; idx: (N,) int32
    on the same device with values in [0, R) (not checked). Returns (N, D)
    in the table's dtype.
    """
    global launches, wide_launches, narrow_launches
    if not table.is_cuda:
        raise ValueError("gather_rows_cuda needs a CUDA table")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("gather_rows: table must be a contiguous (R, D) tensor")
    if idx.device != table.device or idx.dtype != torch.int32 \
            or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("gather_rows: idx must be a contiguous (N,) int32 "
                         "tensor on the table's device")
    n, dim = idx.shape[0], table.shape[1]
    if n >= 2**31:
        raise ValueError(f"gather_rows: {n} ids is too many")
    out = torch.empty((n, dim), dtype=table.dtype, device=table.device)
    if n == 0 or dim == 0:
        return out
    row_bytes = dim * table.element_size()
    chunk = chunk_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    _build.launch("gather_rows", table.device, table.data_ptr(),
                  idx.data_ptr(), out.data_ptr(), n, row_bytes, chunk)
    launches += 1
    if chunk == 16:
        wide_launches += 1
    else:
        narrow_launches += 1
    return out
