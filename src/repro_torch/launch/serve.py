"""Serving entry point (counterpart of ``repro.launch.serve``): batched greedy
generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        [--smoke | --full] --batch 4 --prompt-len 16 --new-tokens 16 \\
        [--device cuda|cpu]

``--arch`` is any LM id the port registers: the dense transformers
tinyllama-1.1b and qwen3-0.6b (flash attention on prefill, plain attention
over the KV cache in decode) and rwkv6-3b (the wkv6 kernel on prefill and
on every decode step, a recurrent state in place of the KV cache).

Runs on the card unless ``--device cpu`` is given (there is no silent
fallback). Params are random, from ``--seed``; the prompt is the synthetic
zipf token stream's first batch. One short warm-up generation (the kernels'
build and load, the library handles) runs before the timed one, which prints
the prefill time, the decode time per token and the tokens generated per
second. ``--pool-backend`` (serving embeddings from the pool) is not ported
yet and raises.
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
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool-backend", default="",
                    help="serve embedding lookups from the pool: not ported "
                         "yet, raises")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)
    if args.pool_backend:
        ap.error(f"--pool-backend {args.pool_backend}: serving from the pool "
                 "is not ported yet")
    if args.prompt_len < 1 or args.new_tokens < 1:
        ap.error("--prompt-len and --new-tokens must be at least 1")

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke).model
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = get_api(cfg).init(gen, cfg)
    prompt = make_batches(cfg, args.batch, args.prompt_len,
                          device=device).next(0)["tokens"]
    max_seq = args.prompt_len + args.new_tokens

    greedy_generate(cfg, params, prompt, min(2, args.new_tokens), max_seq=max_seq)
    stats = {}
    toks = greedy_generate(cfg, params, prompt, args.new_tokens,
                           max_seq=max_seq, stats=stats)
    total_s = stats["prefill_s"] + stats["decode_s"]
    decode = (f"{1e3 * stats['decode_s'] / (args.new_tokens - 1):.2f} ms per token"
              if args.new_tokens > 1 else "no step")
    print(f"[serve] {cfg.name} on {device}: batch {args.batch}, prompt "
          f"{args.prompt_len}, {args.new_tokens} new tokens")
    print(f"[serve] prefill {1e3 * stats['prefill_s']:.2f} ms, decode "
          f"{decode}, {args.batch * args.new_tokens / total_s:.1f} tokens/s")
    print("[serve] sample:", toks[0].tolist())


if __name__ == "__main__":
    main()
