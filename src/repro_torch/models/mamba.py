"""Selective SSM block, jamba's mamba layer (counterpart of
``repro.models.mamba``), in the SSD form of the reference: channels grouped
into heads of ``HEAD_P`` with a scalar decay per head, the scan chunked into
matmuls within a chunk and a recurrence across chunks.

The reference computes it in plain jnp, with no Pallas kernel, so this port
is plain torch too: einsums, a cumsum and a host loop over the chunks. The
f32 params (``dt_bias``, ``a_log``, ``d_skip``) stay in f32, and the scan
runs in f32 whatever the activation dtype.

A state ``{"h": (B, H, N, P) f32, "conv": (B, K-1, di)}`` is updated in
place, as the port's KV caches are. S = 1 with a state is a decode step;
S > 1 is a prefill from zeros. A prefill that would continue a filled state
(``cache_index`` > 0) raises: the reference starts its scan from zeros and
pads its conv with zeros there whatever the state holds
(``src/repro/models/mamba.py:119-150``), a silently wrong result.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MAMBA_HEAD_P as HEAD_P  # channels per SSD head
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers

CHUNK = 128  # the SSD scan's chunk (the largest divisor of S up to it)


def init_mamba(gen: torch.Generator, cfg, new=None, keep=None):
    """The mixer's params. ``keep``: as ``layers.dense_init``'s (a rank's
    blocks of the four projections under a ``heads`` or ``w_embed``
    rule)."""
    d = cfg.d_model
    di = cfg.mamba.d_inner(d)
    ds, dc = cfg.mamba.d_state, cfg.mamba.d_conv
    nh = cfg.mamba.num_heads(d)
    dt, f32 = cfg.activation_dtype, torch.float32
    new = new or layers.fresh(gen.device)

    def proj(name, a, b):
        return layers.dense_init(gen, a, b, dt, new, keep, f"mamba/{name}")
    p = {"in_proj": proj("in_proj", d, 2 * di),
         "conv_w": layers.uniform_init(gen, (dc, di), math.sqrt(1.0 / dc), dt, new),
         "conv_b": new((di,), dt).zero_(),
         "bc_proj": proj("bc_proj", di, 2 * ds),                      # B, C
         "dt_proj": proj("dt_proj", di, nh)}                          # per-head dt
    # dt = softplus(dt_bias) drawn from U(0.001, 0.1): the inverse softplus
    p["dt_bias"] = new((nh,), f32).uniform_(0.001, 0.1, generator=gen).expm1_().log_()
    p["a_log"] = new((nh,), f32).copy_(
        torch.log(torch.arange(1, nh + 1, dtype=f32, device=gen.device)))
    p["d_skip"] = layers.ones(gen, (nh,), f32, new)
    p["out_proj"] = proj("out_proj", di, d)
    p["norm_w"] = layers.ones(gen, (di,), dt, new)
    return p


def _taps(xp, w, b, S: int):
    """sum_i xp[:, i:i+S] * w[i] + b: the K taps in order, in f32, rounded
    once to xp's dtype. The prefill's conv and the decode step's window
    run this one arithmetic, so in bf16 they give the same bits for the
    same window (the reference rounds each tap's product and sum in the
    prefill, and sums the decode's window in a matmul)."""
    out = xp[:, 0:S].float() * w[0].float()
    for i in range(1, w.shape[0]):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return (out + b.float()).to(xp.dtype)


def _conv1d_causal(x, w, b):
    """Depthwise causal conv. x: (B, S, di); w: (K, di)."""
    return _taps(F.pad(x, (0, 0, w.shape[0] - 1, 0)), w, b, x.shape[1])


def _ssd_chunked(xh, dt, a, B_, C_, chunk: int):
    """Chunked scan from a zero state. xh: (B, S, H, P); dt: (B, S, H);
    a: (H,) < 0; B_, C_: (B, S, N).

    y_t = C_t . h_t,  h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T
    Returns (y (B, S, H, P), h_final (B, H, N, P)), in f32. The chunk is the
    largest divisor of S not above ``chunk``.
    """
    Bb, S, H, P = xh.shape
    N = B_.shape[-1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    nc = S // chunk
    f32 = torch.float32
    ldec = dt * a[None, None, :]                                    # (B,S,H)
    xs = (xh * dt[..., None]).reshape(Bb, nc, chunk, H, P).to(f32)
    ld = ldec.reshape(Bb, nc, chunk, H)
    Bc = B_.reshape(Bb, nc, chunk, N).to(f32)
    Cc = C_.reshape(Bb, nc, chunk, N).to(f32)

    cum = torch.cumsum(ld, dim=2)                                   # (B,nc,Q,H)
    # intra-chunk: y_t += C_t.B_j exp(cum_t - cum_j) x_j  for j <= t
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]             # (B,nc,Q,Q,H)
    # exp(-inf) = 0 above the diagonal: the reference's where(causal,
    # exp(seg), 0) in the forward, with no inf there (seg > 0 can overflow)
    # for the backward to multiply by 0
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device).tril()
    dmask = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], -math.inf))
    cb = torch.einsum("bntm,bnsm->bnts", Cc, Bc)                    # (B,nc,Q,Q)
    y_in = torch.einsum("bntsh,bnshp->bnthp", cb[..., None] * dmask, xs)

    # each chunk's contribution to the state at its end
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum)                 # (B,nc,Q,H)
    state_c = torch.einsum("bnsm,bnshp->bnhmp", Bc, dec_to_end[..., None] * xs)
    chunk_dec = torch.exp(cum[:, :, -1, :])                         # (B,nc,H)

    h = torch.zeros((Bb, H, N, P), dtype=f32, device=xh.device)
    h_prev = []                                                     # state BEFORE chunk n
    for n in range(nc):
        h_prev.append(h)
        h = h * chunk_dec[:, n, :, None, None] + state_c[:, n]
    h_prev = torch.stack(h_prev, dim=1)                             # (B,nc,H,N,P)
    # inter-chunk: y_t += C_t . (exp(cum_t) h_prev)
    y_cross = torch.einsum("bntm,bnhmp->bnthp", Cc, h_prev) * torch.exp(cum)[..., None]
    return (y_in + y_cross).reshape(Bb, S, H, P), h


def _rms_norm(y, w, eps: float, di: int):
    """``layers.rms_norm`` over the whole ``di`` channels where ``y`` holds
    this rank's ``di / tp`` of them: the sum of squares summed over the TP
    axis in f32 (``tensor_parallel.psum``)."""
    if tp.size() == 1:
        return layers.rms_norm(y, w, eps)
    yf = y.float()
    ss = tp.psum((yf * yf).sum(dim=-1, keepdim=True))
    return (yf * torch.rsqrt(ss / di + eps) * w.float()).to(y.dtype)


def mamba_fwd(p, cfg, x, *, state=None, cache_index=None):
    """x: (B, S, d). state: dict(h (B, H, N, P) f32, conv (B, K-1, di)),
    written in place: a decode step (S = 1) advances it, a prefill (S > 1,
    ``cache_index`` 0 or None) leaves its final state there.

    Under dense tensor parallelism (``distributed.tensor_parallel``; the
    reference's layout, ``src/repro/models/mamba.py:106-155`` under its
    rules) a rank runs ``nh / tp`` SSD heads, its ``di / tp`` channels:
    ``x`` enters whole (gathered along the sequence under SP), ``in_proj``
    projects the rank's channels of ``xi`` and of ``z``
    (``fsdp.in_proj_cols``), the conv and the per-head leaves are its
    slices, ``bc_proj`` and ``dt_proj`` are row-parallel, their f32
    partials summed over the ranks and rounded once to the activations'
    dtype before the scan (B and C whole, dt then cut to the rank's
    heads), the gated norm sums its squares over the ranks, and
    ``out_proj`` is row-parallel (``fsdp.row_parallel``). The state holds the
    rank's heads and channels: h (B, H / tp, N, P), conv (B, K-1, di / tp).

    Returns (out (B, S, d), state).
    """
    x = tp.enter(x)
    B, S, d = x.shape
    di = cfg.mamba.d_inner(d)
    nh = cfg.mamba.num_heads(d)
    ds, K = cfg.mamba.d_state, cfg.mamba.d_conv
    n, r = tp.size(), tp.rank()
    di_l, nh_l = di // n, nh // n
    ch, hs = slice(r * di_l, (r + 1) * di_l), slice(r * nh_l, (r + 1) * nh_l)
    decode = state is not None and S == 1
    if state is not None and not decode and (cache_index or 0) > 0:
        raise ValueError(
            f"a mamba prefill of {S} tokens at cache_index {cache_index}: the "
            "chunked scan starts from a zero state, so it cannot continue a "
            "filled one (prefill once, at 0, then decode one token a step)")
    xi, z = fsdp.mm(x, p["in_proj"], cfg, "mamba/in_proj").chunk(2, dim=-1)  # (B,S,di_l)
    conv_w, conv_b = p["conv_w"][:, ch], p["conv_b"][ch]

    if decode:
        # rolling conv window over the raw in_proj activations
        win = torch.cat([state["conv"], xi], dim=1)                 # (B,K,di_l)
        xc = F.silu(_taps(win, conv_w, conv_b, 1))                  # (B,1,di_l)
        new_conv = win[:, 1:]
    else:
        xc = F.silu(_conv1d_causal(xi, conv_w, conv_b))
        if S >= K - 1:
            new_conv = xi[:, S - (K - 1):]
        else:
            new_conv = F.pad(xi, (0, 0, K - 1 - S, 0))

    # B, C and dt: each rank's partial products in f32, summed over the
    # ranks and rounded once to the activations' dtype, as one rank's
    # product is, before the f32 scan
    bcdt = tp.psum(torch.cat([fsdp.mm(xc, p[name], cfg, f"mamba/{name}", f32=True)
                              for name in ("bc_proj", "dt_proj")], dim=-1))
    bcdt = bcdt.to(xc.dtype).float()
    B_, C_ = bcdt[..., :2 * ds].chunk(2, dim=-1)                    # (B,S,N)
    dtv = bcdt[..., 2 * ds:][..., hs] + p["dt_bias"][hs]
    dt = torch.logaddexp(dtv, torch.zeros((), dtype=dtv.dtype, device=dtv.device))
    a = -torch.exp(p["a_log"][hs])                                  # (H_l,) < 0
    xh = xc.reshape(B, S, nh_l, HEAD_P)

    if decode:
        dec = torch.exp(dt[:, 0] * a[None, :])                      # (B,H_l)
        upd = torch.einsum("bm,bhp->bhmp", B_[:, 0],
                           (xh[:, 0] * dt[:, 0, :, None]).float())
        h = state["h"] * dec[..., None, None] + upd
        y = torch.einsum("bm,bhmp->bhp", C_[:, 0], h).reshape(B, 1, di_l)
    else:
        y, h = _ssd_chunked(xh.float(), dt, a, B_, C_, CHUNK)
        y = y.reshape(B, S, di_l)
    if state is not None:
        state["h"].copy_(h)
        state["conv"].copy_(new_conv)
    y = y + xc.float() * p["d_skip"][hs].repeat_interleave(HEAD_P)[None, None, :]
    y = y.to(x.dtype) * F.silu(z)
    y = _rms_norm(y, p["norm_w"][ch], cfg.norm_eps, di)
    return fsdp.row_parallel(y, p["out_proj"], cfg, "mamba/out_proj"), state


def init_mamba_state(cfg, batch: int, device):
    """A zeroed state; under dense tensor parallelism the rank's SSD heads
    and channels (the reference's decode layout, H and di over
    ``model``)."""
    d = cfg.d_model
    n = tp.size()
    di = cfg.mamba.d_inner(d) // n
    nh = di // HEAD_P
    return {"h": torch.zeros((batch, nh, cfg.mamba.d_state, HEAD_P),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.mamba.d_conv - 1, di),
                                dtype=cfg.activation_dtype, device=device)}
