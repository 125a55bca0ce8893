"""The RWKV-6 time-mix recurrence (wkv6) on the card, forward and backward.

Counterpart of ``wkv6_pallas`` (``repro/kernels/wkv6.py``); the forward
kernels are in ``csrc/wkv6.cu``, whose header says how they are laid out,
what bounds them and where they depart from the Pallas kernel (they take an
initial state and return the final one). A sequence (S > 1) runs the
chunked kernel, a decode step (S = 1) the one-pass kernel; the shape
chooses. The backward (``csrc/wkv6_bwd.cu``) has no Pallas counterpart: the
JAX package differentiates ``wkv6_chunked`` through XLA. ``WKV6`` ties the
two together for autograd. Their plain versions are ``ref.wkv6_ref`` and
``ref.wkv6_bwd_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches made by wkv6_cuda, either route
decode_launches = 0   # those on the decode route (S = 1)
bwd_launches = 0      # calls of wkv6_bwd_cuda (each the walk and the du sum)
HEAD_K = 64           # the head size the kernels are built for (chunks: 16 rows)


def _checked_strides(op, r, k, v, logw, u, s0, s_out=None):
    """Checks the inputs as both directions take them; returns the r, k, v
    and logw batch, sequence and head strides (elements)."""
    if not r.is_cuda:
        raise ValueError(f"{op} needs CUDA tensors")
    if r.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{op}: unsupported dtype {r.dtype}")
    if r.dim() != 4 or r.shape[3] != HEAD_K:
        raise ValueError(f"{op}: want r (B, S, H, {HEAD_K}), got {tuple(r.shape)}")
    B, S, H, K = r.shape
    if S == 0:
        raise ValueError(f"{op}: needs at least one token")
    strides = []
    for name, t, dtype in (("r", r, r.dtype), ("k", k, r.dtype), ("v", v, r.dtype),
                           ("logw", logw, torch.float32)):
        if t.shape != r.shape or t.dtype != dtype or t.device != r.device:
            raise ValueError(f"{op}: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {tuple(r.shape)} {dtype} on {r.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{op}: {name} needs a contiguous last axis")
        if t.data_ptr() % 16 or any(t.shape[i] > 1 and t.stride(i) * t.element_size() % 16
                                    for i in range(3)):
            raise ValueError(f"{op}: {name} needs a 16-byte aligned start and batch, "
                             f"sequence and head strides of whole 16-byte units; got "
                             f"strides {t.stride()} of {t.element_size()}-byte elements")
        strides += t.stride()[:3]
    for name, t, shape in (("u", u, (H, K)), ("s0", s0, (B, H, K, K)),
                           ("s_out", s_out, (B, H, K, K))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or t.device != r.device or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"{op}: {name} must be a contiguous, 16-byte aligned "
                             f"{shape} f32 tensor on {r.device}")
    return strides


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
    strides = _checked_strides("wkv6", r, k, v, logw, u, s0, s_out)
    B, S, H, K = r.shape
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


def wkv6_bwd_cuda(r, k, v, logw, u, s0, dy, ds_fin=None):
    """Gradients of ``wkv6_cuda``'s (y, s_fin); see ``ref.wkv6_bwd_ref``.

    r, k, v, logw, u, s0 as ``wkv6_cuda`` takes them (the same checks);
    dy: (B, S, H, 64) f32, contiguous and 16-byte aligned (the kernel reads
    it by TMA too); ds_fin: contiguous (B, H, 64, 64) f32 or None for zero.
    Returns (dr, dk, dv) in r's dtype, dlogw (B, S, H, 64) f32, du (H, 64)
    f32 summed over the batch in a fixed order, and ds0 (B, H, 64, 64) f32
    (None when s0 is None). The wrapper allocates the kernel's scratch: the
    state at each 16-row chunk's start, B H ceil(S / 16) x 16 KB.
    """
    global bwd_launches
    strides = _checked_strides("wkv6_bwd", r, k, v, logw, u, s0)
    B, S, H, K = r.shape
    for name, t, shape in (("dy", dy, (B, S, H, K)), ("ds_fin", ds_fin, (B, H, K, K))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or t.device != r.device or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"wkv6_bwd: {name} must be a contiguous, 16-byte "
                             f"aligned {shape} f32 tensor on {r.device}")
    dr, dk, dv = (torch.empty((B, S, H, K), dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dlogw = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, K), dtype=torch.float32, device=r.device)
    du = torch.empty((H, K), dtype=torch.float32, device=r.device)
    ds0 = None if s0 is None else torch.empty_like(s0)
    states = torch.empty((B, H, -(-S // ref.WKV6_CHUNK), K, K), dtype=torch.float32,
                         device=r.device)
    _build.launch("wkv6_bwd", r.device, *(t.data_ptr() for t in (r, k, v, logw, u)),
                  None if s0 is None else s0.data_ptr(), dy.data_ptr(),
                  None if ds_fin is None else ds_fin.data_ptr(),
                  *(t.data_ptr() for t in (dr, dk, dv, dlogw, du_part, du)),
                  None if ds0 is None else ds0.data_ptr(), states.data_ptr(),
                  _build.DTYPE_CODES[r.dtype], B, S, H, *strides)
    bwd_launches += 1
    return dr, dk, dv, dlogw, du, ds0


class WKV6(torch.autograd.Function):
    """wkv6 whose forward and backward are the kernels on the card and
    their plain versions on the CPU (dispatched by ``ops``).

    The forward saves its inputs; the backward recomputes the chunk-start
    states from them, so no state is kept between the two. Returns (y,
    s_fin); either's gradient may be absent (s_fin's usually is).
    """

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        from repro_torch.kernels import ops
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        return ops.wkv6(r, k, v, logw, u, s0)

    @staticmethod
    def backward(ctx, dy, ds_fin):
        from repro_torch.kernels import ops
        r, k, v, logw, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dr, dk, dv, dlogw, du, ds0 = ops.wkv6_bwd(
            r, k, v, logw, u, s0, dy.float().contiguous(),
            None if ds_fin is None else ds_fin.float().contiguous())
        return dr, dk, dv, dlogw, du, ds0
