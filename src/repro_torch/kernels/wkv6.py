"""The RWKV-6 time-mix recurrence (wkv6) on the card, forward.

Counterpart of ``wkv6_pallas`` (``repro/kernels/wkv6.py``); the kernels are
in ``csrc/wkv6.cu``, whose header says how they are laid out, what bounds
them and where they depart from the Pallas kernel (they take an initial
state and return the final one). A sequence (S > 1) runs the chunked
kernel, a decode step (S = 1) the one-pass kernel; the shape chooses. Their
plain version is ``ref.wkv6_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches made by wkv6_cuda, either route
decode_launches = 0   # those on the decode route (S = 1)
HEAD_K = 64           # the head size the kernels are built for (chunks: 16 rows)


def wkv6_cuda(r, k, v, logw, u, s0=None, *, s_out=None):
    """Chunked wkv6 with a (64 x 64) f32 state per head; see ``ref.wkv6_ref``.

    r, k, v: (B, S, H, 64), one of f32/f16/bf16; logw: (B, S, H, 64) f32,
    clamped to [-5, -1e-4] (not checked); all four on one CUDA device with
    a contiguous last axis, a 16-byte aligned start and batch, sequence and
    head strides of whole 16-byte units, as the chunked kernel's TMA copies
    need (anything else raises). u: (H, 64) f32; s0: (B, H, 64, 64) f32
    or None for zero; both contiguous. Returns (y (B, S, H, 64) f32, s_fin
    (B, H, 64, 64) f32). With ``s_out`` (contiguous (B, H, 64, 64) f32,
    which may be s0 itself) the final state is written there and it is
    returned.
    """
    global launches, decode_launches
    if not r.is_cuda:
        raise ValueError("wkv6_cuda needs CUDA tensors")
    if r.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"wkv6: unsupported dtype {r.dtype}")
    if r.dim() != 4 or r.shape[3] != HEAD_K:
        raise ValueError(f"wkv6: want r (B, S, H, {HEAD_K}), got {tuple(r.shape)}")
    B, S, H, K = r.shape
    if S == 0:
        raise ValueError("wkv6: needs at least one token")
    strides = []
    for name, t, dtype in (("r", r, r.dtype), ("k", k, r.dtype), ("v", v, r.dtype),
                           ("logw", logw, torch.float32)):
        if t.shape != r.shape or t.dtype != dtype or t.device != r.device:
            raise ValueError(f"wkv6: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {tuple(r.shape)} {dtype} on {r.device}")
        if t.stride(3) != 1:
            raise ValueError(f"wkv6: {name} needs a contiguous last axis")
        if t.data_ptr() % 16 or any(t.shape[i] > 1 and t.stride(i) * t.element_size() % 16
                                    for i in range(3)):
            raise ValueError(f"wkv6: {name} needs a 16-byte aligned start and batch, "
                             f"sequence and head strides of whole 16-byte units; got "
                             f"strides {t.stride()} of {t.element_size()}-byte elements")
        strides += t.stride()[:3]
    for name, t, shape in (("u", u, (H, K)), ("s0", s0, (B, H, K, K)),
                           ("s_out", s_out, (B, H, K, K))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or t.device != r.device or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"wkv6: {name} must be a contiguous, 16-byte aligned "
                             f"{shape} f32 tensor on {r.device}")
    y = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
    s_fin = s_out if s_out is not None else torch.empty(
        (B, H, K, K), dtype=torch.float32, device=r.device)
    _build.launch("wkv6", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  logw.data_ptr(), u.data_ptr(),
                  None if s0 is None else s0.data_ptr(), y.data_ptr(),
                  s_fin.data_ptr(), _build.DTYPE_CODES[r.dtype], B, S, H, *strides)
    launches += 1
    decode_launches += S == 1
    return y, s_fin
