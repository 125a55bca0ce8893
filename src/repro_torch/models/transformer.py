"""Decoder-only LM stack (counterpart of ``repro.models.transformer``).

Dense homogeneous stacks only (tinyllama, qwen3-0.6b): every layer is
attention plus a dense FFN. Block params are stacked along a leading layer
axis, as the reference stacks them for ``lax.scan``, so a JAX param tree
crosses over through ``interop`` unchanged; here a Python loop walks the
layers. Jamba groups, MoE, mamba and vision embeds raise
``NotImplementedError``.

KV caches keep the reference's layout, ``{"k", "v"}`` of (L, B, Smax, Hkv,
D), and are written in place: ``prefill`` and ``decode_step`` return the
cache they were given.

Training differentiates ``lm_loss`` with torch autograd. With ``cfg.remat``
each block runs under ``torch.utils.checkpoint``, as the reference wraps
its block in ``jax.checkpoint`` (``src/repro/models/transformer.py:139``):
only the block's input is kept, and the block (its flash-attention forward
included) runs again in the backward.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import embedding_ops
from repro_torch.models import layers
from repro_torch.tree import tree_map


def _check_supported(cfg) -> None:
    if cfg.arch_type != "transformer" or cfg.mrope_sections \
            or set(cfg.layer_types) != {"attn"} or set(cfg.ffn_types) != {"dense"}:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention stacks only "
            "(jamba, MoE, mamba and vision embeds are not ported yet)")


def _init_block(gen: torch.Generator, cfg):
    dt = cfg.activation_dtype
    return {"norm1": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
            "norm2": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
            "attn": layers.init_attention(gen, cfg),
            "mlp": layers.init_mlp(gen, cfg)}


def init_lm(gen: torch.Generator, cfg):
    """Random params on ``gen``'s device in the reference's tree layout."""
    _check_supported(cfg)
    dt = cfg.activation_dtype
    table = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                         device=gen.device) * 0.02).to(dt)
    params = {"embed": {"table": table},
              "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    blocks = [_init_block(gen, cfg) for _ in range(cfg.num_layers)]
    params["blocks"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
    return params


def _block_fwd(p, cfg, x, positions, cache=None, cache_index=None):
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    o, cache = layers.attention_fwd(p["attn"], cfg, h, positions, causal=True,
                                    cache=cache, cache_index=cache_index)
    x = x + o
    h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + layers.mlp_fwd(p["mlp"], cfg, h), cache


def forward_hidden(params, cfg, tokens, *, caches=None, cache_index=None,
                   vision_embeds=None, embed_rows=None):
    """tokens: (B, S) -> (hidden (B, S, d), caches).

    The token embedding goes through the row-gather kernel, unless
    ``embed_rows`` gives the (B, S, d) rows already gathered (the relaxed
    lookup's prefetch). Tokens sit at positions cache_index .. cache_index
    + S - 1. With grad on and ``cfg.remat``, each block is checkpointed.
    """
    if vision_embeds is not None:
        raise NotImplementedError("vision embeds are not ported yet")
    _check_supported(cfg)
    S = tokens.shape[1]
    if embed_rows is not None:
        x = embed_rows.to(cfg.activation_dtype)
    else:
        x = embedding_ops.lookup(params["embed"]["table"], tokens)
    positions = (cache_index or 0) + torch.arange(S, device=tokens.device)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for i, bp in enumerate(layers.layer_params(params["blocks"], cfg.num_layers)):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda bp, x: _block_fwd(bp, cfg, x, positions)[0], bp, x,
                use_reentrant=False)
            continue
        cache = None if caches is None else {"k": caches["k"][i], "v": caches["v"][i]}
        x, _ = _block_fwd(bp, cfg, x, positions, cache, cache_index)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def head_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]


def lm_loss(params, cfg, batch):
    """Mean token cross-entropy. batch: tokens (B, S), labels (B, S) [,
    loss_mask, embed_rows (the relaxed lookup's prefetched rows)]."""
    hidden, _ = forward_hidden(params, cfg, batch["tokens"],
                               embed_rows=batch.get("embed_rows"))
    loss, count = layers.chunked_softmax_xent(
        hidden, head_matrix(params, cfg), batch["labels"],
        chunk=cfg.loss_chunk, mask=batch.get("loss_mask"))
    return loss / torch.clamp(count, min=1.0)


def init_kv_cache(cfg, batch: int, max_seq: int, device):
    """Zeroed caches {"k", "v"} of (L, batch, max_seq, Hkv, D) on ``device``."""
    _check_supported(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {n: torch.zeros(shape, dtype=cfg.activation_dtype, device=device)
            for n in ("k", "v")}


def prefill(params, cfg, tokens, caches):
    """Fill caches with S tokens at positions 0 .. S-1; return (last-token
    logits (B, V) f32, caches)."""
    hidden, caches = forward_hidden(params, cfg, tokens, caches=caches,
                                    cache_index=0)
    return (hidden[:, -1] @ head_matrix(params, cfg)).float(), caches


def decode_step(params, cfg, tokens, pos: int, caches):
    """tokens: (B, 1) at position ``pos`` (a host int) -> (logits (B, V)
    f32, caches)."""
    hidden, caches = forward_hidden(params, cfg, tokens, caches=caches,
                                    cache_index=pos)
    return (hidden[:, -1] @ head_matrix(params, cfg)).float(), caches
