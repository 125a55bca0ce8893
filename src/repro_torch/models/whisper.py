"""Whisper-base backbone, encoder and decoder (counterpart of
``repro.models.whisper``).

The audio frontend is the reference's stub: a batch carries precomputed
frame embeddings ``frames`` (B, Sf, d). The encoder adds sine positions to
them and runs pre-LN blocks of full (not causal) self-attention and a gelu
MLP. The decoder adds sine positions to the token rows and runs pre-LN
blocks of causal self-attention (with a KV cache when serving),
cross-attention over the encoder's output and a gelu MLP. The output head
is tied to the token table: logits are ``hidden @ table.T``.

Params keep the reference's tree: ``enc_blocks`` and ``dec_blocks`` each
stack their layers' leaves along a leading axis (allocated once through
``layers.Stack``, each layer drawn into its slice), so a JAX param tree
crosses over through ``interop`` unchanged. The cross-attention's K and V
of every decoder layer are computed once from the encoder's output
(``cross_kv``, stacked (L, B, Sf, Hkv, D)); serving computes them once a
request and reads them in every decode step. Self-attention and, for more
than one query, cross-attention go through the flash kernels
(``causal=False`` for the encoder and the cross-attention); a decode
step's cross-attention is the plain ``decode_attention`` over all Sf
keys, as in the reference.

Where the reference builds the 65,536-row sine table on every decoder
call, the port computes the rows at the tokens' positions only; they are
elementwise the table's rows.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import embedding_ops
from repro_torch.distributed import context_parallel, tensor_parallel
from repro_torch.models import layers


def _init_enc_block(gen: torch.Generator, cfg, new=None):
    d, dt = cfg.d_model, cfg.activation_dtype
    return {"ln1_w": layers.ones(gen, (d,), dt, new), "ln1_b": layers.zeros(gen, (d,), dt, new),
            "ln2_w": layers.ones(gen, (d,), dt, new), "ln2_b": layers.zeros(gen, (d,), dt, new),
            "attn": layers.init_attention(gen, cfg, new),
            "mlp": layers.init_mlp(gen, cfg, new=new)}


def _init_dec_block(gen: torch.Generator, cfg, new=None):
    d, dt = cfg.d_model, cfg.activation_dtype
    return {"ln1_w": layers.ones(gen, (d,), dt, new), "ln1_b": layers.zeros(gen, (d,), dt, new),
            "ln2_w": layers.ones(gen, (d,), dt, new), "ln2_b": layers.zeros(gen, (d,), dt, new),
            "ln3_w": layers.ones(gen, (d,), dt, new), "ln3_b": layers.zeros(gen, (d,), dt, new),
            "attn": layers.init_attention(gen, cfg, new),
            "xattn": layers.init_attention(gen, cfg, new),
            "mlp": layers.init_mlp(gen, cfg, new=new)}


def _stacked(gen, cfg, init_block, n):
    stack = layers.Stack(n, gen.device)
    trees = [init_block(gen, cfg, stack.layer(i)) for i in range(n)]
    return stack.tree(trees[0])


def init_lm(gen: torch.Generator, cfg):
    """Random params on ``gen``'s device in the reference's tree layout."""
    d, dt = cfg.d_model, cfg.activation_dtype
    table = (torch.randn((cfg.vocab_size, d), generator=gen, device=gen.device)
             * 0.02).to(dt)
    return {"embed": {"table": table},
            "enc_blocks": _stacked(gen, cfg, _init_enc_block, cfg.encoder_layers),
            "dec_blocks": _stacked(gen, cfg, _init_dec_block, cfg.num_layers),
            "enc_ln_w": layers.ones(gen, (d,), dt), "enc_ln_b": layers.zeros(gen, (d,), dt),
            "dec_ln_w": layers.ones(gen, (d,), dt), "dec_ln_b": layers.zeros(gen, (d,), dt)}


def _remat(cfg, caches=None) -> bool:
    return cfg.remat and caches is None and torch.is_grad_enabled()


def _enc_block(bp, cfg, x, pos):
    h = layers.layer_norm(x, bp["ln1_w"], bp["ln1_b"], cfg.norm_eps)
    o, _ = layers.attention_fwd(bp["attn"], cfg, h, pos, causal=False)
    x = x + o
    h = layers.layer_norm(x, bp["ln2_w"], bp["ln2_b"], cfg.norm_eps)
    return x + layers.mlp_fwd(bp["mlp"], cfg, h)


def encode(params, cfg, frames):
    """frames: (B, Sf, d) precomputed frame embeddings (the stub frontend)
    -> the encoder's output (B, Sf, d) in the activation dtype."""
    tensor_parallel.check_supported(cfg)
    _, Sf, d = frames.shape
    x = frames.to(cfg.activation_dtype)
    x = x + layers.sinusoidal_positions(Sf, d, device=x.device).to(x.dtype)[None]
    pos = torch.arange(Sf, device=x.device)
    for bp in layers.layer_params(params["enc_blocks"], cfg.encoder_layers):
        if _remat(cfg):
            x = torch.utils.checkpoint.checkpoint(
                lambda bp, x: _enc_block(bp, cfg, x, pos), bp, x, use_reentrant=False)
        else:
            x = _enc_block(bp, cfg, x, pos)
    return layers.layer_norm(x, params["enc_ln_w"], params["enc_ln_b"], cfg.norm_eps)


def cross_kv(params, cfg, enc_out):
    """Every decoder layer's cross-attention K and V from the encoder's
    output: a pair of (L, B, Sf, Hkv, D) tensors."""
    B, Sf, _ = enc_out.shape
    shape = (B, Sf, cfg.num_kv_heads, cfg.resolved_head_dim)
    per = layers.layer_params(params["dec_blocks"], cfg.num_layers)
    k = torch.stack([(enc_out @ bp["xattn"]["wk"]).reshape(shape) for bp in per])
    v = torch.stack([(enc_out @ bp["xattn"]["wv"]).reshape(shape) for bp in per])
    return k, v


def _dec_block(bp, cfg, x, pos, xk, xv, cache=None, cache_index=None):
    h = layers.layer_norm(x, bp["ln1_w"], bp["ln1_b"], cfg.norm_eps)
    o, _ = layers.attention_fwd(bp["attn"], cfg, h, pos, causal=True, cache=cache,
                                cache_index=cache_index)
    x = x + o
    h = layers.layer_norm(x, bp["ln2_w"], bp["ln2_b"], cfg.norm_eps)
    o, _ = layers.attention_fwd(bp["xattn"], cfg, h, pos, causal=False,
                                cross_kv=(xk, xv))
    x = x + o
    h = layers.layer_norm(x, bp["ln3_w"], bp["ln3_b"], cfg.norm_eps)
    return x + layers.mlp_fwd(bp["mlp"], cfg, h)


def decode_hidden(params, cfg, tokens, xkv, *, caches=None, cache_index=None,
                  embed_rows=None):
    """tokens: (B, S) at positions cache_index .. cache_index + S - 1 ->
    (hidden (B, S, d), caches). ``xkv`` is ``cross_kv``'s pair; ``caches``
    the self-attention's {"k", "v"} of (L, B, Smax, Hkv, D), written in
    place. The token rows go through the row-gather kernel unless
    ``embed_rows`` gives them (the relaxed lookup's prefetch)."""
    tensor_parallel.check_supported(cfg)
    S, d = tokens.shape[1], cfg.d_model
    if embed_rows is not None:
        x = embed_rows.to(cfg.activation_dtype)
    else:
        x = embedding_ops.lookup(params["embed"]["table"], tokens)
    base = cache_index or 0
    x = x + layers.sinusoidal_positions(S, d, start=base, device=x.device).to(x.dtype)[None]
    pos = base + torch.arange(S, device=x.device)
    xk, xv = xkv
    for i, bp in enumerate(layers.layer_params(params["dec_blocks"], cfg.num_layers)):
        if _remat(cfg, caches):
            x = torch.utils.checkpoint.checkpoint(
                lambda bp, x, k, v: _dec_block(bp, cfg, x, pos, k, v),
                bp, x, xk[i], xv[i], use_reentrant=False)
        else:
            cache = None if caches is None else {n: caches[n][i] for n in ("k", "v")}
            x = _dec_block(bp, cfg, x, pos, xk[i], xv[i], cache, cache_index)
    return layers.layer_norm(x, params["dec_ln_w"], params["dec_ln_b"], cfg.norm_eps), caches


def head_matrix(params, cfg):
    """The tied head: the token table, transposed (a view)."""
    return params["embed"]["table"].T


def lm_loss(params, cfg, batch):
    """Mean token cross-entropy. batch: frames (B, Sf, d), tokens (B, S),
    labels (B, S) [, embed_rows]. The head is the token table, so with the
    table requiring grad its gradient is dense (every row)."""
    xkv = cross_kv(params, cfg, encode(params, cfg, batch["frames"]))
    hidden, _ = decode_hidden(params, cfg, batch["tokens"], xkv,
                              embed_rows=batch.get("embed_rows"))
    loss, count = layers.chunked_softmax_xent(hidden, head_matrix(params, cfg),
                                              batch["labels"], chunk=cfg.loss_chunk)
    return loss / torch.clamp(count, min=1.0)


def init_kv_cache(cfg, batch: int, max_seq: int, device):
    """The decoder's self-attention caches, zeroed: {"k", "v"} of (L, B,
    max_seq, Hkv, D) in the activation dtype. Not under a ``cache_seq``
    rule: whisper's decoder cache is not sharded by sequence yet."""
    if context_parallel.cache_axes():
        raise NotImplementedError(
            "whisper: the decoder's cache under a cache_seq rule (context-parallel "
            "decode) is not ported yet; serve whisper without the rule")
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {n: torch.zeros(shape, dtype=cfg.activation_dtype, device=device)
            for n in ("k", "v")}


def _xkv(params, cfg, frames, xkv):
    if xkv is not None:
        return xkv
    if frames is None:
        raise ValueError("whisper: give the request's frames or its cross K/V (xkv)")
    return cross_kv(params, cfg, encode(params, cfg, frames))


def prefill(params, cfg, tokens, caches, *, frames=None, xkv=None):
    """Fill the caches with the S prompt tokens; return (last-token logits
    (B, V) f32, caches). The cross K/V are ``xkv`` when given (computed
    once a request), else encoded from ``frames``."""
    hidden, caches = decode_hidden(params, cfg, tokens, _xkv(params, cfg, frames, xkv),
                                   caches=caches, cache_index=0)
    return (hidden[:, -1] @ head_matrix(params, cfg)).float(), caches


def decode_step(params, cfg, tokens, pos: int, caches, *, xkv=None, frames=None):
    """tokens: (B, 1) at position ``pos`` (a host int) -> (logits (B, V)
    f32, caches), against the cross K/V ``xkv`` (else encoded from
    ``frames``, as the reference's registry does)."""
    hidden, caches = decode_hidden(params, cfg, tokens, _xkv(params, cfg, frames, xkv),
                                   caches=caches, cache_index=pos)
    return (hidden[:, -1] @ head_matrix(params, cfg)).float(), caches
