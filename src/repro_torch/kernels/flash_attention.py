"""Flash attention on the card (forward).

Counterpart of ``flash_attention_pallas`` (``repro/kernels/flash_attention.py``);
the kernel is ``csrc/flash_attention.cu``, whose header says how it is laid
out, what bounds it and where it departs from the Pallas kernel. Its plain
version is ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches made by flash_attention_cuda
HEAD_DIMS = (16, 64, 128)   # the head sizes the kernel is built for


def _strides(t):
    """Batch, sequence and head strides of a (B, S, H, D) tensor; a size-1
    axis is never stepped over, so its stride reads as 0."""
    return [0 if n == 1 else st for n, st in zip(t.shape[:3], t.stride()[:3],
                                                 strict=True)]


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """softmax(q k^T / sqrt(D)) v with f32 scores, softmax and P.V.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with Hq % Hkv == 0 (q head h
    reads kv head h // (Hq / Hkv)); all three f32/f16/bf16 of one type on
    one CUDA device, D in ``HEAD_DIMS``. Any batch, sequence and head
    strides (a prefix of a KV cache is read in place); the last axis must be
    contiguous and every stride and base 4-element aligned. Query row i sits
    at position ``q_offset + i`` and key j at j; ``causal`` masks keys past
    the query's position. Returns (B, Sq, Hq, D) in q's type, contiguous.
    """
    global launches
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B, Sq, Hq, D) and k, v "
                         f"(B, Sk, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {D} not in {HEAD_DIMS}")
    if Sk == 0 or q_offset < 0:
        raise ValueError("flash_attention: needs a key and q_offset >= 0")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        st = _strides(t)
        if t.stride(3) != 1 or any(x % 4 for x in st) \
                or t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"flash_attention: {name} needs a contiguous last "
                             "axis and 4-element aligned strides and base")
        strides += st
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[q.dtype],
                  B, Sq, Sk, Hq, Hkv, D, *strides, int(causal), q_offset)
    launches += 1
    return out
