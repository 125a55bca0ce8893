"""Batched serving (counterpart of the LM loop of the JAX package's
``examples/serve_batched.py``): prefill a batch of prompts, then decode
with a shared stepped loop (``training.serve_loop.greedy_generate``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        [--arch tinyllama-1.1b|qwen3-0.6b|rwkv6-3b] [--device cuda|cpu]

Smoke-size model with random weights from seed 0. The JAX example's
``--pool-backend`` drill (serving lookups from the trainer's pool) is not
ported and raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import LM_IDS, get_arch
from repro_torch.data.synthetic import make_batches
from repro_torch.models.registry import get_api
from repro_torch.training.serve_loop import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=LM_IDS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--pool-backend", default="",
                    help="the pool-serving drill: not ported yet, raises")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)
    if args.pool_backend:
        raise NotImplementedError(
            f"--pool-backend {args.pool_backend}: serving lookups from the "
            "pool is not ported yet (ROADMAP queue 1 item 2)")
    if args.prompt_len < 1 or args.new_tokens < 1:
        ap.error("--prompt-len and --new-tokens must be at least 1")
    device = resolve_device(args.device)

    cfg = get_arch(args.arch, smoke=True).model
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = get_api(cfg).init(gen, cfg)
    prompt = make_batches(cfg, args.batch, args.prompt_len,
                          device=device).next(0)["tokens"]
    stats = {}
    toks = greedy_generate(cfg, params, prompt, args.new_tokens, stats=stats)
    if not torch.isfinite(stats["logits"]).all():
        raise SystemExit("non-finite logits")
    print(f"[prefill] {cfg.name} on {device}: {args.batch}x{args.prompt_len} "
          f"tokens in {stats['prefill_s'] * 1e3:.1f}ms")
    rate = (f" -> {args.batch * args.new_tokens / stats['decode_s']:.0f} tok/s"
            if args.new_tokens > 1 else "")
    print(f"[decode] {args.batch}x{args.new_tokens} tokens in "
          f"{stats['decode_s'] * 1e3:.1f}ms{rate}")
    print("[sample]", toks[0].tolist())


if __name__ == "__main__":
    main()
