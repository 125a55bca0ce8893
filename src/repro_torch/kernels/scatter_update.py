"""Sparse in-place row update on the card, plain and with undo capture.

Counterparts of ``scatter_update_pallas`` and ``scatter_update_logged_pallas``
(``repro/kernels/scatter_update.py``); the kernels are
``csrc/scatter_update.cu`` and ``csrc/scatter_update_logged.cu``, whose
headers say how they are laid out, what bounds them, and why pad slots
carry index -1. Their plain versions are ``ref.scatter_update_ref`` and
``ref.scatter_update_logged_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches made by scatter_update_cuda
launches_logged = 0   # kernel launches made by scatter_update_logged_cuda


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
    global launches
    n, dim = _check("scatter_update", table, idx, delta)
    if n == 0 or dim == 0:
        return table
    _build.launch("scatter_update", table.device,
                  table.data_ptr(), _build.DTYPE_CODES[table.dtype],
                  idx.data_ptr(), delta.data_ptr(), n, dim)
    launches += 1
    return table


def scatter_update_logged_cuda(table, idx, delta):
    """``scatter_update_cuda`` that first copies each updated row into an
    undo buffer (paper Fig. 7).

    Same arguments. Returns ``(table, old)``: old (N, D) in the table's
    dtype, old[i] the bits of table[idx[i]] before the update, +0 for a pad.
    """
    global launches_logged
    n, dim = _check("scatter_update_logged", table, idx, delta)
    old = torch.empty((n, dim), dtype=table.dtype, device=table.device)
    if n == 0 or dim == 0:
        return table, old
    _build.launch("scatter_update_logged", table.device,
                  table.data_ptr(), _build.DTYPE_CODES[table.dtype],
                  idx.data_ptr(), delta.data_ptr(), old.data_ptr(), n, dim)
    launches_logged += 1
    return table, old
