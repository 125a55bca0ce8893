"""Serving steps (counterpart of ``repro.training.serve_loop``): prefill
fills the KV caches, decode adds one token against them, and
``greedy_generate`` runs both in a host loop.

The decode position is a host int, so on the kernels' route the loop never
waits for the card to read it; the next token stays on the card.

Under a sharding context every rank runs the same loop on the same
prompt: the models read the context (the near-data lookup, dense tensor
parallelism with each rank's kv heads and jamba's SSD heads in its
caches, expert parallelism, or context-parallel decode), and each rank
gets the whole logits and tokens.

A request's extras ride in its batch: qwen2-vl's ``vision_embeds`` and
``positions3`` go to the prefill (its decode steps use plain rope, as the
reference's do); whisper's ``frames`` are encoded once a request by
``serve_extras`` into the decoder's cross-attention K/V, which the prefill
and every decode step read (the reference encodes them twice, in its
prefill and in ``serve_extras``; the values are the same).

``pool_serving`` / ``make_pool_serve_fns`` hook the pool-backed embedding
serving tier (``repro_torch.serve``) into the model path: inside the
context, every ``embedding_ops.lookup`` / ``bag_lookup`` the models issue
reads the trainer's pool-resident mirror through the tier's batched,
cached path. That route reads its ids on the host, so each prefill and
each decode step waits once for the card to produce its tokens (one sync a
step, as the JAX package's host callback makes).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.models import whisper
from repro_torch.models.registry import get_api

# the batch keys each family's prefill takes besides the tokens
PREFILL_EXTRAS = {"qwen2vl": ("vision_embeds", "positions3"),
                  "whisper": ("frames", "xkv")}


def make_serve_fns(cfg):
    """Returns (prefill_step, decode_step, init_cache) for ``cfg``."""
    api = get_api(cfg)
    if api.decode_step is None:
        raise NotImplementedError(f"{cfg.name} has no decode step")
    keys = PREFILL_EXTRAS.get(cfg.arch_type, ())

    def prefill_step(params, batch, caches):
        """tokens (B, S) [and the family's extras] -> (next-token logits
        (B, V) f32, filled caches)."""
        kw = {k: batch[k] for k in keys if batch.get(k) is not None}
        return api.prefill(params, cfg, batch["tokens"], caches, **kw)

    def decode_step(params, tokens, pos: int, caches, extras=None):
        """tokens (B, 1) at position ``pos``, the cache filled below it;
        ``extras`` as ``serve_extras`` gives them."""
        return api.decode_step(params, cfg, tokens, pos, caches, **(extras or {}))

    def init_cache(batch: int, max_seq: int, device):
        return api.init_cache(cfg, batch, max_seq, device)

    return prefill_step, decode_step, init_cache


def serve_extras(cfg, params, batch) -> dict:
    """The per-request state computed once, outside the decode loop:
    whisper's cross-attention K/V from the batch's frames (``xkv``); none
    for the other families."""
    if cfg.arch_type == "whisper":
        enc = whisper.encode(params, cfg, batch["frames"])
        return {"xkv": whisper.cross_kv(params, cfg, enc)}
    return {}


@contextlib.contextmanager
def pool_serving(tier):
    """Route embedding lookups through a pool-backed serving tier
    (``repro_torch.serve.EmbeddingServeTier``, or any
    ``EmbeddingPoolMirror``-compatible object) for the duration of the
    context."""
    from repro_torch.core import embedding_ops
    embedding_ops.attach_pool(tier)
    try:
        with embedding_ops.lookup_mode("pool"):
            yield tier
    finally:
        embedding_ops.detach_pool()


def make_pool_serve_fns(tier):
    """Host-side embedding serving closures over a pool-backed tier:
    (lookup, bag_lookup, serve_batch), for request frontends that batch ids
    themselves."""
    def lookup(ids):
        return tier.lookup(np.asarray(ids))

    def bag_lookup(ids, combine: str = "sum"):
        return tier.bag_lookup(np.asarray(ids), combine=combine)

    def serve_batch(requests):
        return tier.serve_batch([np.asarray(r) for r in requests])

    return lookup, bag_lookup, serve_batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(cfg, params, prompt_tokens, num_new: int, *,
                    extras: dict | None = None, max_seq: int | None = None,
                    stats: dict | None = None, part=None):
    """Prefill the prompt, then decode ``num_new - 1`` more tokens greedily.

    prompt_tokens: (B, S) ints on the params' device; ``extras`` the
    request's other batch entries (qwen2-vl's ``vision_embeds`` and
    ``positions3``, whisper's ``frames``), which the prefill part takes in
    (whisper's frames encoded there, once). Returns the (B, num_new)
    int32 tokens: the prefill's argmax, then one per decode step. If
    ``stats`` is a dict it receives ``prefill_s`` and ``decode_s`` (host
    clock; the card is synchronised before the prefill, after it and at the
    end) and ``logits``, the (B, num_new, V) f32 logits behind the tokens.
    ``part``, if given, is called with "prefill" and then "decode" and
    returns a context manager entered around that part (a profiler, say).
    """
    part = part or (lambda name: contextlib.nullcontext())
    prefill_step, decode_step, init_cache = make_serve_fns(cfg)
    B, S = prompt_tokens.shape
    device = prompt_tokens.device
    caches = init_cache(B, max_seq or (S + num_new), device)
    if stats is not None:
        _sync(device)
        t0 = time.perf_counter()
    with part("prefill"):
        batch = {**(extras or {}), "tokens": prompt_tokens}
        request = serve_extras(cfg, params, batch)
        logits, caches = prefill_step(params, {**batch, **request}, caches)
        out, kept = [logits.argmax(dim=-1).to(torch.int32)], [logits]
    if stats is not None:
        _sync(device)
        t1 = time.perf_counter()
    with part("decode"):
        for t in range(num_new - 1):
            logits, caches = decode_step(params, out[-1][:, None], S + t, caches,
                                         request)
            out.append(logits.argmax(dim=-1).to(torch.int32))
            kept.append(logits)
    if stats is not None:
        _sync(device)
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     logits=torch.stack(kept, dim=1))
    return torch.stack(out, dim=1)
