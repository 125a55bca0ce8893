"""Serving entry point (counterpart of ``repro.launch.serve``): batched greedy
generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        [--smoke | --full] --batch 4 --prompt-len 16 --new-tokens 16 \\
        [--device cuda|cpu] [--pool-backend dram|pmem|remote|sharded
        [--pool-dir DIR] [--pool-addr unix:/path|tcp:host:port
        [--pool-readonly]] [--pool-shards A1,A2,...] [--pool-cache-rows N]]

``--arch`` is any LM id the port registers: the dense transformers
tinyllama-1.1b, qwen3-0.6b, llama3.2-3b and granite-20b and the MoE ones
qwen3-moe-235b-a22b and arctic-480b (flash attention on prefill, plain
attention over the KV cache in decode), rwkv6-3b (the wkv6 kernel on
prefill and on every decode step, a recurrent state in place of the KV
cache), jamba-v0.1-52b (attention one layer in 8, mamba layers with a
recurrent state in the others, MoE every other layer), qwen2-vl-7b (M-RoPE;
the prompt's first S/8 slots are stub vision embeds) and whisper-base
(stub audio frames encoded once a request; the decoder attends to them
through cross-attention, its head tied to the token table). ``--full`` builds
the whole published model: granite-20b's 56 GB in bf16 fits on an 80 GB
H100, but jamba-v0.1-52b, qwen3-moe-235b-a22b and arctic-480b do not
(``chip_smoke.py`` serves them at full width with fewer layers).

Runs on the card unless ``--device cpu`` is given (there is no silent
fallback). Params are random, from ``--seed``; the prompt is the synthetic
zipf token stream's first batch, with that batch's vision embeds and M-RoPE
positions (qwen2-vl) or frames (whisper). One short warm-up generation (the kernels'
build and load, the library handles) runs before the timed one, which prints
the prefill time, the decode time per token and the tokens generated per
second.

``--pool-backend`` routes the model's token lookups through the pool-backed
serving tier (``repro_torch.serve.EmbeddingServeTier``): the table is
mirrored in f32 into the pool's ``embedding-mirror/rows`` region (a pmem
pool's image is ``<--pool-dir>/pool.img``) and every lookup becomes a
batched, hot-row-cached near-memory gather on the host; the tier's stats
line follows the timings. ``--pool-backend remote --pool-addr A`` serves
from a memory node (``python -m repro_torch.pool.server --addr A ...``);
with ``--pool-readonly`` the connection is a read-only tenant, which
writes nothing and serves the mirror a trainer (or an earlier serving run
without the flag) left in the node: the node denies every mutating op on
that connection. ``--pool-backend sharded --pool-shards A1,A2,...`` puts
the mirror on the node its placement names among several. whisper-base
is not served from the pool: its tied head reads the whole table on the
card.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import LM_IDS, get_arch
from repro_torch.data.synthetic import make_batches
from repro_torch.models.registry import get_api
from repro_torch.training.serve_loop import greedy_generate, pool_serving

_LOAD_BYTES = 64 << 20   # f32 bytes of the table widened per copy


def build_tier(table, backend: str, *, pool_dir: str = "",
               cache_rows: int = 4096, addr: str = "",
               readonly: bool = False, shards: str = ""):
    """The serving tier over a pool that holds ``table`` (V, d), as the
    trainer's checkpoint manager lays it out: f32 rows in
    ``embedding-mirror/rows``. The pool is sized to the table, and the rows
    are widened and written a bounded chunk at a time. A pmem pool's image
    is ``<pool_dir>/pool.img``; a remote pool is the node at ``addr``, a
    sharded one the nodes of ``shards``. A ``readonly`` tenant writes
    nothing: the rows must be in the node."""
    from repro_torch.pool import PoolAllocator, make_pool
    from repro_torch.pool.allocator import DATA_START
    from repro_torch.serve import EmbeddingServeTier

    V, d = table.shape
    row_bytes = 4 * d
    pool = make_pool(backend,
                     path=os.path.join(pool_dir, "pool.img") if pool_dir else None,
                     capacity=DATA_START + V * row_bytes + (1 << 20),
                     addr=addr, readonly=readonly, shards=shards)
    if readonly:
        return EmbeddingServeTier(pool, cache_rows=cache_rows)
    region = PoolAllocator(pool).domain("embedding-mirror").alloc(
        "rows", shape=(V, d), dtype="float32")
    step = max(1, _LOAD_BYTES // row_bytes)
    for s in range(0, V, step):
        rows = table[s:s + step].detach().float().cpu().numpy()
        pool.write(region.off + s * row_bytes, rows, tag="mirror-load")
    region.persist(point="mirror-load")
    return EmbeddingServeTier(pool, cache_rows=cache_rows)


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
                    choices=["", "dram", "pmem", "remote", "sharded"],
                    help="serve token lookups from the pool through the "
                         "hot-row-cached tier")
    ap.add_argument("--pool-addr", default="",
                    help="remote backend: unix:/path or tcp:host:port")
    ap.add_argument("--pool-shards", default="",
                    help="sharded backend: comma list of node addrs")
    ap.add_argument("--pool-dir", default="",
                    help="pmem backend: directory for the pool image")
    ap.add_argument("--pool-cache-rows", type=int, default=4096)
    ap.add_argument("--pool-readonly", action="store_true",
                    help="connect to a remote pool as a read-only tenant "
                         "(the mirror must already be in the node)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)
    if args.pool_readonly and args.pool_backend != "remote":
        ap.error("--pool-readonly: a read-only tenant needs "
                 "--pool-backend remote")
    if args.pool_backend == "remote" and not args.pool_addr:
        ap.error("--pool-backend remote needs --pool-addr (start one: "
                 "python -m repro_torch.pool.server --addr ...)")
    if args.pool_backend == "sharded" and not args.pool_shards:
        ap.error("--pool-backend sharded needs --pool-shards addr1,addr2,...")
    if args.prompt_len < 1 or args.new_tokens < 1:
        ap.error("--prompt-len and --new-tokens must be at least 1")

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke).model
    if args.pool_backend and cfg.tie_embeddings:
        ap.error(f"--pool-backend: {args.arch}'s head is tied to the token table, "
                 "which it reads whole on the card; pool serving is not ported")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = get_api(cfg).init(gen, cfg)
    batch = make_batches(cfg, args.batch, args.prompt_len, device=device).next(0)
    prompt = batch["tokens"]
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    max_seq = args.prompt_len + args.new_tokens
    with contextlib.ExitStack() as stack:
        tier = None
        if args.pool_backend:
            pool_dir = args.pool_dir
            if args.pool_backend == "pmem" and not pool_dir:
                # an image without --pool-dir lives as long as the run
                pool_dir = stack.enter_context(
                    tempfile.TemporaryDirectory(prefix="serve_pool_"))
            tier = build_tier(params["embed"]["table"], args.pool_backend,
                              pool_dir=pool_dir, cache_rows=args.pool_cache_rows,
                              addr=args.pool_addr, readonly=args.pool_readonly,
                              shards=args.pool_shards)
            stack.callback(tier.pool.close)
            stack.enter_context(pool_serving(tier))
        greedy_generate(cfg, params, prompt, min(2, args.new_tokens),
                        extras=extras, max_seq=max_seq)
        stats = {}
        toks = greedy_generate(cfg, params, prompt, args.new_tokens, extras=extras,
                               max_seq=max_seq, stats=stats)
        tier_stats = None if tier is None else (
            tier.stats(), tier.pool.metrics.link_bytes())
    total_s = stats["prefill_s"] + stats["decode_s"]
    decode = (f"{1e3 * stats['decode_s'] / (args.new_tokens - 1):.2f} ms per token"
              if args.new_tokens > 1 else "no step")
    print(f"[serve] {cfg.name} on {device}: batch {args.batch}, prompt "
          f"{args.prompt_len}, {args.new_tokens} new tokens")
    print(f"[serve] prefill {1e3 * stats['prefill_s']:.2f} ms, decode "
          f"{decode}, {args.batch * args.new_tokens / total_s:.1f} tokens/s")
    print("[serve] sample:", toks[0].tolist())
    if tier_stats is not None:
        s, link = tier_stats
        print(f"[serve] pool tier ({args.pool_backend}): {s['requests']} "
              f"lookups, hit_rate={s['hit_rate']:.2f} p50={s['p50_ms']:.2f}ms "
              f"p99={s['p99_ms']:.2f}ms inval={s['invalidations']} link "
              f"bytes={link}")


if __name__ == "__main__":
    main()
