"""Sparse in-place row update on the card, plain and with undo capture.

Counterparts of ``scatter_update_pallas`` and ``scatter_update_logged_pallas``
(``repro/kernels/scatter_update.py``); the kernels are
``csrc/scatter_update.cu`` and ``csrc/scatter_update_logged.cu``, on the
layout of ``csrc/row_update.cuh``; their headers say how they are laid
out, what bounds them, and why pad slots carry index -1. Their plain
versions are ``ref.scatter_update_ref`` and ``ref.scatter_update_logged_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches made by scatter_update_cuda
wide_launches = 0     # those that moved 16 bytes of the table a chunk
narrow_launches = 0   # those that moved narrower chunks
launches_logged = 0         # kernel launches made by scatter_update_logged_cuda
wide_launches_logged = 0    # those that moved 16 bytes of the table a chunk
narrow_launches_logged = 0  # those that moved narrower chunks


def chunk_elems(elem_size: int, dim: int, table_ptr: int, delta_ptr: int,
                old_ptr: int = 0) -> int:
    """Elements a thread of the update kernels moves as one chunk: the
    largest of 8, 4, 2 and 1 whose table bytes are at most 16, that divides
    the row, and whose table bytes and f32 delta (up to 16 bytes a load)
    both bases hold whole; for the logged update the undo buffer's base
    ``old_ptr`` must hold the table bytes whole too."""
    return next(v for v in (8, 4, 2, 1)
                if v * elem_size <= 16 and dim % v == 0
                and table_ptr % (v * elem_size) == 0 and old_ptr % (v * elem_size) == 0
                and delta_ptr % (4 * min(v, 4)) == 0)


def _check(op: str, table, idx, delta) -> tuple[int, int]:
    """(N, D) of a valid call; raises on what the kernels do not take."""
    if not table.is_cuda:
        raise ValueError(f"{op}_cuda needs a CUDA table")
    if table.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{op}: unsupported table dtype {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{op}: table must be a contiguous (R, D) tensor")
    if idx.device != table.device or idx.dtype != torch.int32 \
            or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{op}: idx must be a contiguous (N,) int32 "
                         "tensor on the table's device")
    n, dim = idx.shape[0], table.shape[1]
    if delta.device != table.device or delta.dtype != torch.float32 \
            or tuple(delta.shape) != (n, dim) or not delta.is_contiguous():
        raise ValueError(f"{op}: delta must be a contiguous ({n}, {dim}) "
                         "f32 tensor on the table's device")
    if n >= 2**31:
        raise ValueError(f"{op}: {n} slots is too many")
    return n, dim


def scatter_update_cuda(table, idx, delta):
    """table[idx[i]] = round(f32(table[idx[i]]) + delta[i]) in place.

    table: (R, D) f32/f16/bf16 on a CUDA device; idx: (N,) int32, each row
    at most once, -1 for a pad slot that is skipped; delta: (N, D) f32.
    Returns ``table``.
    """
    global launches, wide_launches, narrow_launches
    n, dim = _check("scatter_update", table, idx, delta)
    if n == 0 or dim == 0:
        return table
    vec = chunk_elems(table.element_size(), dim, table.data_ptr(), delta.data_ptr())
    _build.launch("scatter_update", table.device,
                  table.data_ptr(), _build.DTYPE_CODES[table.dtype],
                  idx.data_ptr(), delta.data_ptr(), n, dim, vec)
    launches += 1
    if vec * table.element_size() == 16:
        wide_launches += 1
    else:
        narrow_launches += 1
    return table


def scatter_update_logged_cuda(table, idx, delta):
    """``scatter_update_cuda`` that first copies each updated row into an
    undo buffer (paper Fig. 7).

    Same arguments. Returns ``(table, old)``: old (N, D) in the table's
    dtype, old[i] the bits of table[idx[i]] before the update, +0 for a pad.
    """
    global launches_logged, wide_launches_logged, narrow_launches_logged
    n, dim = _check("scatter_update_logged", table, idx, delta)
    old = torch.empty((n, dim), dtype=table.dtype, device=table.device)
    if n == 0 or dim == 0:
        return table, old
    vec = chunk_elems(table.element_size(), dim, table.data_ptr(), delta.data_ptr(),
                      old.data_ptr())
    _build.launch("scatter_update_logged", table.device,
                  table.data_ptr(), _build.DTYPE_CODES[table.dtype],
                  idx.data_ptr(), delta.data_ptr(), old.data_ptr(), n, dim, vec)
    launches_logged += 1
    if vec * table.element_size() == 16:
        wide_launches_logged += 1
    else:
        narrow_launches_logged += 1
    return table, old
