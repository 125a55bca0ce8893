"""RWKV-6 "Finch", the attention-free LM with data-dependent decay
(counterpart of ``repro.models.rwkv6``).

Each block is a time mix (token shift, the r/k/v/g projections, the decay
LoRA, the wkv6 recurrence through ``ops.wkv6``, a per-head groupnorm) and a
channel mix (the relu^2 FFN), each on the rms-normed residual. Block params
are stacked along a leading layer axis, as the reference stacks them for
``lax.scan``, so a JAX param tree crosses over through ``interop``
unchanged; here a Python loop walks the layers.

The recurrent cache keeps the reference's layout, ``{"tmix": {"shift":
(L, B, d), "s": (L, B, H, K, K) f32}, "cmix": (L, B, d)}``, and is written
in place: ``prefill`` and ``decode_step`` return the cache they were given.
Its size does not grow with the sequence. Matmuls in f32 run without TF32
(torch's default), which the decay LoRA's f32 product relies on.

Training differentiates ``lm_loss`` with torch autograd; ``ops.wkv6`` is
then the ``WKV6`` function, whose backward is the wkv6 backward kernel.
With ``cfg.remat`` each block runs under ``torch.utils.checkpoint``, as the
reference wraps its block in ``jax.checkpoint`` with ``nothing_saveable``
(``src/repro/models/rwkv6.py:233-235``): only the block's input is kept,
and the block (its wkv6 forward included) runs again in the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core import embedding_ops
from repro_torch.distributed import tensor_parallel
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.tree import tree_map

HEAD_K = 64          # rwkv6 head size
LORA_R = 64          # decay LoRA rank
# The chunked wkv6 forms exp(+-cumsum of the log decay) over a chunk; with
# logw >= -5 and 16-row chunks the largest exponent is 80, inside f32.
LOG_W_MIN = -5.0     # per-step log-decay clamp
WKV_CHUNK = ref.WKV6_CHUNK   # rows per wkv6 chunk (fixed by the kernel)


def _check_supported(cfg) -> None:
    if cfg.arch_type != "rwkv6" or cfg.d_model % HEAD_K:
        raise NotImplementedError(f"{cfg.name}: not an rwkv6 config with "
                                  f"heads of {HEAD_K}")
    tensor_parallel.check_supported(cfg)


def _token_shift(x, prev):
    """Shift right by one; prev: (B, d), the last token of the previous
    segment."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(x, xprev, mu):
    return x + (xprev - x) * mu


def init_rwkv(gen: torch.Generator, cfg, new=None):
    """One block's params: ``mu``, the LoRA, ``w_base``, ``u``, ``ln_w`` and
    ``ln_b`` in f32, the rest in the activation dtype. ``new`` allocates
    the leaves (``layers.Stack``)."""
    d, dt = cfg.d_model, cfg.activation_dtype
    H = d // HEAD_K
    f32 = torch.float32
    new = new or layers.fresh(gen.device)
    tm = {
        "mu": layers.uniform_init(gen, (5, d), 0.5, f32, new),   # r, k, v, g, w mix
        "wr": layers.dense_init(gen, d, d, dt, new),
        "wk": layers.dense_init(gen, d, d, dt, new),
        "wv": layers.dense_init(gen, d, d, dt, new),
        "wg": layers.dense_init(gen, d, d, dt, new),
        "wo": layers.dense_init(gen, d, d, dt, new),
        "w_lora_a": layers.dense_init(gen, d, LORA_R, f32, new),
        "w_lora_b": layers.dense_init(gen, LORA_R, d, f32, new),
        "w_base": new((d,), f32).uniform_(-6.0, -5.0, generator=gen),
        "u": layers.uniform_init(gen, (H, HEAD_K), 0.3, f32, new),
        "ln_w": layers.ones(gen, (d,), f32, new),    # per-head groupnorm
        "ln_b": new((d,), f32).zero_(),
    }
    cm = {
        "mu": layers.uniform_init(gen, (2, d), 0.5, f32, new),
        "wk": layers.dense_init(gen, d, cfg.d_ff, dt, new),
        "wv": layers.dense_init(gen, cfg.d_ff, d, dt, new),
        "wr": layers.dense_init(gen, d, d, dt, new),
    }
    return {"norm1": layers.ones(gen, (d,), dt, new),
            "norm2": layers.ones(gen, (d,), dt, new),
            "tmix": tm, "cmix": cm}


def init_lm(gen: torch.Generator, cfg):
    """Random params on ``gen``'s device in the reference's tree layout."""
    _check_supported(cfg)
    dt, dev = cfg.activation_dtype, gen.device
    table = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                         device=dev) * 0.02).to(dt)
    # each stacked leaf allocated once, every layer drawn into its slice
    stack = layers.Stack(cfg.num_layers, dev)
    trees = [init_rwkv(gen, cfg, stack.layer(i)) for i in range(cfg.num_layers)]
    return {"embed": {"table": table},
            "blocks": stack.tree(trees[0]),
            "norm_in": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "lm_head": layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)}


def time_mix(p, cfg, x, *, state=None):
    """x: (B, S, d) -> (out (B, S, d), state).

    state: None (zero shift and zero wkv state, nothing kept) or dict(shift
    (B, d), s (B, H, K, K) f32), read and then updated in place: shift
    becomes x's last token and s the final wkv state.
    """
    B, S, d = x.shape
    H = d // HEAD_K
    prev = state["shift"] if state is not None else x.new_zeros((B, d))
    xs = _token_shift(x, prev)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (_ddlerp(x, xs, mu[i]) for i in range(5))
    r = (xr @ p["wr"]).reshape(B, S, H, HEAD_K)
    k = (xk @ p["wk"]).reshape(B, S, H, HEAD_K)
    v = (xv @ p["wv"]).reshape(B, S, H, HEAD_K)
    g = F.silu(xg @ p["wg"])
    ww = p["w_base"] + (xw.float() @ p["w_lora_a"]) @ p["w_lora_b"]   # (B, S, d)
    logw = torch.clamp(-torch.exp(ww), LOG_W_MIN, -1e-4).reshape(B, S, H, HEAD_K)
    s0 = state["s"] if state is not None else None
    y, _ = ops.wkv6(r, k, v, logw, p["u"], s0, s_out=s0)
    # per-head groupnorm (population variance, as jnp.var)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = (y.reshape(B, S, d) * p["ln_w"] + p["ln_b"]).to(x.dtype)
    if state is not None:
        state["shift"].copy_(x[:, -1, :])
    return (y * g) @ p["wo"], state


def channel_mix(p, cfg, x, *, state=None):
    """The relu^2 FFN with a token shift. state: None or the (B, d) shift,
    read and then set to x's last token in place."""
    B, S, d = x.shape
    prev = state if state is not None else x.new_zeros((B, d))
    xs = _token_shift(x, prev)
    mu = p["mu"].to(x.dtype)
    xk = _ddlerp(x, xs, mu[0])
    xr = _ddlerp(x, xs, mu[1])
    kk = torch.square(torch.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"])
    if state is not None:
        state.copy_(x[:, -1, :])
    return out, state


def _block(p, cfg, x, state):
    st_t = state["tmix"] if state is not None else None
    st_c = state["cmix"] if state is not None else None
    o, _ = time_mix(p["tmix"], cfg, layers.rms_norm(x, p["norm1"], cfg.norm_eps),
                    state=st_t)
    x = x + o
    o, _ = channel_mix(p["cmix"], cfg, layers.rms_norm(x, p["norm2"], cfg.norm_eps),
                       state=st_c)
    return x + o


def forward_hidden(params, cfg, tokens, *, caches=None, embed_rows=None):
    """tokens: (B, S) -> (hidden (B, S, d), caches), the caches (if any)
    carried from their state and updated in place.

    The token embedding goes through the row-gather kernel, unless
    ``embed_rows`` gives the (B, S, d) rows already gathered (the relaxed
    lookup's prefetch). With grad on and ``cfg.remat``, each block is
    checkpointed.
    """
    _check_supported(cfg)
    if embed_rows is not None:
        x = embed_rows.to(cfg.activation_dtype)
    else:
        x = embedding_ops.lookup(params["embed"]["table"], tokens)
    x = layers.rms_norm(x, params["norm_in"], cfg.norm_eps)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for i, bp in enumerate(layers.layer_params(params["blocks"], cfg.num_layers)):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda bp, x: _block(bp, cfg, x, None), bp, x, use_reentrant=False)
            continue
        st = None if caches is None else tree_map(lambda a, i=i: a[i], caches)
        x = _block(bp, cfg, x, st)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def lm_loss(params, cfg, batch):
    """Mean token cross-entropy. batch: tokens (B, S), labels (B, S) [,
    embed_rows (the relaxed lookup's prefetched rows)]."""
    hidden, _ = forward_hidden(params, cfg, batch["tokens"],
                               embed_rows=batch.get("embed_rows"))
    loss, count = layers.chunked_softmax_xent(
        hidden, params["lm_head"], batch["labels"], chunk=cfg.loss_chunk)
    return loss / torch.clamp(count, min=1.0)


def init_kv_cache(cfg, batch: int, max_seq: int, device):
    """Zeroed recurrent state on ``device``: O(1) in the sequence length, so
    ``max_seq`` is not used."""
    _check_supported(cfg)
    L, d, dt = cfg.num_layers, cfg.d_model, cfg.activation_dtype
    H = d // HEAD_K
    return {"tmix": {"shift": torch.zeros((L, batch, d), dtype=dt, device=device),
                     "s": torch.zeros((L, batch, H, HEAD_K, HEAD_K),
                                      dtype=torch.float32, device=device)},
            "cmix": torch.zeros((L, batch, d), dtype=dt, device=device)}


def prefill(params, cfg, tokens, caches):
    """Run S tokens from the caches' state; return (last-token logits (B, V)
    f32, caches)."""
    hidden, caches = forward_hidden(params, cfg, tokens, caches=caches)
    return (hidden[:, -1] @ params["lm_head"]).float(), caches


def decode_step(params, cfg, tokens, pos: int, caches):
    """tokens: (B, 1) -> (logits (B, V) f32, caches). ``pos`` is unused: the
    state carries the position."""
    return prefill(params, cfg, tokens, caches)
