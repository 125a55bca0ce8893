"""Flash attention on the card, forward and backward.

Counterpart of ``flash_attention_pallas`` (``repro/kernels/flash_attention.py``).
Each direction has two routes, declared by the input type: the forward is
``csrc/flash_attention_tc.cu`` (tensor cores) for f16 and bf16 inputs and
``csrc/flash_attention.cu`` (f32 products) for f32 ones; the backward is
``csrc/flash_attention_bwd_tc.cu`` and ``csrc/flash_attention_bwd.cu``
likewise. Their headers say how they are laid out, what bounds them and
where they depart from the reference. The plain versions are
``ref.flash_attention_ref`` and ``ref.flash_attention_bwd_ref``.
``FlashAttention`` ties the two directions into one autograd function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0       # kernel launches made by flash_attention_cuda (both routes)
tc_launches = 0    # those of them on the tensor-core route (f16, bf16)
bwd_launches = 0   # kernel launches made by flash_attention_bwd_cuda
# launches per backward, by input type: Delta, dk and dv, dq for f32; Delta,
# the dk and dv partials, dq, their sum over the q heads for f16 and bf16
BWD_PASSES = {torch.float32: 3, torch.float16: 4, torch.bfloat16: 4}
HEAD_DIMS = (16, 64, 128)   # the head sizes the kernels are built for


def _strides(t):
    """Batch, sequence and head strides of a (B, S, H, D) tensor; a size-1
    axis is never stepped over, so its stride reads as 0."""
    return [0 if n == 1 else st for n, st in zip(t.shape[:3], t.stride()[:3],
                                                 strict=True)]


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0,
                         want_lse: bool = False):
    """softmax(q k^T / sqrt(D)) v with f32 scores, softmax and P.V.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with Hq % Hkv == 0 (q head h
    reads kv head h // (Hq / Hkv)); all three f32/f16/bf16 of one type on
    one CUDA device, D in ``HEAD_DIMS``. Any batch, sequence and head
    strides (a prefix of a KV cache is read in place); the last axis must be
    contiguous. Query row i sits at position ``q_offset + i`` and key j at
    j; ``causal`` masks keys past the query's position. Returns (B, Sq, Hq,
    D) in q's type, contiguous; with ``want_lse`` also each row's
    log-sum-exp, (B, Hq, Sq) f32.

    The route is declared by the type, with no fallback between them: f32
    inputs take ``flash_attention.cu`` (products in f32; strides and bases
    4-element aligned); f16 and bf16 inputs take ``flash_attention_tc.cu``,
    whose products run on the tensor cores with P carried as two terms of
    the input type (``ref.flash_attention_ref(..., p_dtype=dtype)`` is its
    plain emulation); its strides and bases must be 16-byte aligned, as its
    TMA copies need.
    """
    global launches, tc_launches
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
    tc = q.dtype != torch.float32
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        st = _strides(t)
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous last axis")
        if tc and (any(x * t.element_size() % 16 for x in st) or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} needs 16-byte aligned "
                             "strides and base for the tensor-core route")
        if not tc and (any(x % 4 for x in st) or t.data_ptr() % (4 * t.element_size())):
            raise ValueError(f"flash_attention: {name} needs 4-element aligned "
                             "strides and base")
        strides += st
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel():
        _build.launch("flash_attention_tc" if tc else "flash_attention", q.device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      None if lse is None else lse.data_ptr(),
                      _build.DTYPE_CODES[q.dtype], B, Sq, Sk, Hq, Hkv, D,
                      *strides, int(causal), q_offset)
        launches += 1
        tc_launches += tc
    return out if lse is None else (out, lse)


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             q_offset: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention_cuda``'s output.

    q, o, do: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); all contiguous, of one
    type (f32/f16/bf16) on one CUDA device, D in ``HEAD_DIMS``; lse: the
    forward's (B, Hq, Sq) f32 log-sum-exp. ``causal`` and ``q_offset`` as
    in the forward. Returns dq, dk, dv in the inputs' type, contiguous.
    Runs ``BWD_PASSES[dtype]`` launches; no atomics, so the result is the
    same on every call.

    The route is declared by the type, with no fallback between them: f32
    inputs take ``flash_attention_bwd.cu`` (products in f32); f16 and bf16
    inputs take ``flash_attention_bwd_tc.cu``, whose products run on the
    tensor cores with P and dS rounded to the input type before they are
    multiplied (``ref.flash_attention_bwd_ref(..., round_to=dtype)`` is its
    plain emulation). Its inputs must be 16-byte aligned.
    """
    global bwd_launches
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd_cuda needs CUDA tensors")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd: unsupported dtype {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: want q, o, do (B, Sq, Hq, D) "
                         f"and k, v (B, Sk, Hkv, D), got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head size {D} not in {HEAD_DIMS}")
    if Sk == 0 or q_offset < 0:
        raise ValueError("flash_attention_bwd: needs a key and q_offset >= 0")
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                    ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be ({B}, {Hq}, {Sq}) "
                         f"f32 on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:          # no query row: nothing reads k or v
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk, dv)]
    if q.dtype == torch.float32:
        name = "flash_attention_bwd"
    else:
        name = "flash_attention_bwd_tc"
        for t_name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_bwd: {t_name} must be "
                                 "16-byte aligned for the tensor-core route")
        # each q head's dK and dV sums, f32 (B, Hq, Sk, D); pass 3 adds them
        # over the heads of a kv head
        parts = [torch.empty((B, Hq, Sk, D), dtype=torch.float32, device=q.device)
                 for _ in range(2)]
        ptrs += [t.data_ptr() for t in parts]
    for p in range(BWD_PASSES[q.dtype]):
        _build.launch(name, q.device, p, *ptrs, _build.DTYPE_CODES[q.dtype],
                      B, Sq, Sk, Hq, Hkv, D, int(causal), q_offset)
        bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the flash kernels on the
    card and their plain versions on the CPU (dispatched by ``ops``).

    The forward saves q, k, v, its output and the row log-sum-exp; the
    backward rebuilds P from them, so no score tensor is kept. ``causal``
    and ``q_offset`` get no gradient.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        from repro_torch.kernels import ops
        o, lse = ops.flash_attention_lse(q, k, v, causal=causal,
                                         q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import ops
        q, k, v, o, lse = (t.contiguous() for t in ctx.saved_tensors)
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                             causal=ctx.causal,
                                             q_offset=ctx.q_offset)
        return dq, dk, dv, None, None
