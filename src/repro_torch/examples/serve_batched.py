"""Batched serving (counterpart of the JAX package's
``examples/serve_batched.py``): prefill a batch of prompts, then decode
with a shared stepped loop (``training.serve_loop.greedy_generate``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        [--arch tinyllama-1.1b|qwen3-0.6b|rwkv6-3b] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --pool-backend dram|pmem|remote|sharded [--pool-addr A] \\
        [--pool-readonly]

Smoke-size model with random weights from seed 0.

With ``--pool-backend dram|pmem|remote|sharded`` the example becomes the
pool-serving drill instead: embedding rows are served straight from the
trainer's pool-resident mirror through ``repro_torch.serve.EmbeddingServeTier``
(batched deduplicated gathers, a trainer-coherent hot-row cache). Trainer
commits are interleaved with serving; each commit must evict exactly the
cached rows it touched, and the rows served after it must be the committed
ones, bit for bit. ``remote`` serves from a memory node: the one at
``--pool-addr``, or one started in this process on a unix socket; with
``--pool-readonly`` the tier reads through a read-only connection of its
own, on which the node denies every write. ``sharded`` puts the mirror
on one of two memory nodes started in this process; after the commits its
read replica is refreshed on the other node, the primary's node is shut
down, and the tier must go on serving the committed rows from the replica
(a failover counted) within its declared staleness of one commit.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import LM_IDS, get_arch
from repro_torch.data.synthetic import make_batches
from repro_torch.models.registry import get_api
from repro_torch.training.serve_loop import greedy_generate

def _pools(args, root: str):
    """(the trainer's pool, the tier's pool, the servers started here): one
    device for dram and pmem; for remote a writable connection for the
    trainer and, with ``--pool-readonly``, a read-only one for the tier;
    for sharded one pool over two nodes."""
    from repro_torch.pool import (DramPool, PmemPool, PoolServer, ShardedPool,
                                  make_pool)
    if args.pool_backend == "sharded":
        servers = [PoolServer(DramPool(1 << 20),
                              f"unix:{root}/serve{i}.sock").start()
                   for i in range(2)]
        pool = ShardedPool([srv.addr for srv in servers])
        return pool, pool, servers
    if args.pool_backend == "dram":
        pool = DramPool(1 << 20)
        return pool, pool, []
    if args.pool_backend == "pmem":
        pool = PmemPool(os.path.join(root, "pool.img"), 1 << 20)
        return pool, pool, []
    servers, addr = [], args.pool_addr
    if not addr:
        servers.append(PoolServer(DramPool(1 << 20),
                                  f"unix:{root}/pool.sock").start())
        addr = servers[0].addr
    pool = make_pool("remote", addr=addr)
    tier_pool = (make_pool("remote", addr=addr, readonly=True)
                 if args.pool_readonly else pool)
    return pool, tier_pool, servers


def pool_main(args):
    from repro_torch.core.checkpoint.undo_log import UndoRing
    from repro_torch.pool import PoolAllocator
    from repro_torch.serve import EmbeddingServeTier, ReplicaReader

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="serve_pool_") as root:
        pool, tier_pool, servers = _pools(args, root)
        alloc = PoolAllocator(pool)

        # the trainer's mirror: V x d rows living in the pool
        V, d = 1 << 12, 32
        table = rng.standard_normal((V, d)).astype(np.float32)
        region = alloc.domain("embedding-mirror").alloc(
            "rows", shape=(V, d), dtype="float32")
        region.write_array(table)
        region.persist(point="mirror-load")
        ring = UndoRing(PoolAllocator(pool), max_logs=16)

        tier = EmbeddingServeTier(tier_pool, cache_rows=args.cache_rows)
        print(f"[pool-serve] backend={args.pool_backend} table={V}x{d} "
              f"cache={args.cache_rows} rows")

        # hot-skewed request stream: 80% of the ids from a hot set of 256
        hot = rng.choice(V, size=256, replace=False)

        def make_requests(n):
            reqs = []
            for _ in range(n):
                k = int(rng.integers(4, 32))
                ids = np.where(rng.random(k) < 0.8, rng.choice(hot, k),
                               rng.integers(0, V, k))
                reqs.append(ids.astype(np.int64))
            return reqs

        for step in range(args.steps):
            # serve a few batches...
            for _ in range(4):
                reqs = make_requests(args.batch)
                for r, ids in zip(tier.serve_batch(reqs), reqs, strict=True):
                    if not np.array_equal(r, table[ids]):
                        raise SystemExit("served rows differ from the mirror")
            # ...then the trainer commits step N touching a known row set
            touched = np.unique(rng.choice(hot, 8))
            inval_before = tier.metrics.cache_invalidations
            expect = sum(1 for i in touched if i in tier.cache)
            new_rows = rng.standard_normal((touched.size, d)).astype(np.float32)
            ring.log_and_apply(step, region, touched, new_rows)
            tier.poll_coherence()
            got = tier.metrics.cache_invalidations - inval_before
            if got != expect:
                raise SystemExit(f"step {step}: {got} rows invalidated, "
                                 f"{expect} of the touched rows were cached")
            # the reads after the commit see the new rows, bit for bit
            rows = tier.serve_batch([touched])[0]
            if rows.tobytes() != new_rows.tobytes():
                raise SystemExit(f"step {step}: served rows differ from the "
                                 "committed ones")
            table[touched] = new_rows
            print(f"[pool-serve] step {step}: commit touched {touched.size} "
                  f"rows, evicted exactly {got} cached")

        if args.pool_backend == "sharded":
            failover(pool, tier, servers, table, make_requests(args.batch),
                     args.steps - 1, ReplicaReader)
        s = tier.stats()
        print(f"[pool-serve] {s['requests']} requests, {s['rows']} rows | "
              f"qps={s['qps']:.0f} p50={s['p50_ms']:.2f}ms "
              f"p99={s['p99_ms']:.2f}ms | hit_rate={s['hit_rate']:.2f} "
              f"inval={s['invalidations']} failovers={s['failovers']}")
        if tier_pool is not pool:
            tier_pool.close()
        pool.close()
        for srv in servers:
            srv.shutdown(close_device=True)
    print("pool-serving drill PASSED")


def failover(pool, tier, servers, table, reqs, last_commit, replica_reader):
    """The sharded drill's last act: refresh the mirror's read replica on
    the other node at the last commit, shut the primary's node down, and
    serve ``reqs`` from the replica: the rows the trainer committed, bit
    for bit, within one commit of staleness."""
    primary = pool.placement.place("embedding-mirror")
    dst = 1 - primary
    pool.replicate_domain("embedding-mirror", dst, watermark=last_commit)
    tier.replica = replica_reader(pool)
    print(f"[pool-serve] replica on shard {dst} (watermark step {last_commit})")
    servers[primary].shutdown()            # the primary's node is gone
    print(f"[pool-serve] killed primary shard {primary}")
    for r, ids in zip(tier.serve_batch(reqs), reqs, strict=True):
        if r.tobytes() != table[ids].tobytes():
            raise SystemExit("rows served from the replica differ from the "
                             "committed ones")
    lag = tier.staleness_bound()
    if tier.failovers < 1:
        raise SystemExit("no read failed over to the replica")
    if lag > 1:
        raise SystemExit(f"staleness {lag} commits > the declared bound of 1")
    print(f"[pool-serve] replica served {len(reqs)} requests after the "
          f"primary's death (staleness <= {lag} commit)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=LM_IDS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--pool-backend", default="",
                    help="dram|pmem|remote|sharded: run the pool-serving "
                         "drill instead of the LM decode loop")
    ap.add_argument("--pool-addr", default="",
                    help="remote: the memory node to serve from (default: "
                         "one started in this process)")
    ap.add_argument("--pool-readonly", action="store_true",
                    help="remote: the tier reads through a read-only "
                         "connection")
    ap.add_argument("--cache-rows", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4,
                    help="pool drill: trainer commits interleaved with "
                         "serving")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)
    if args.pool_backend not in ("", "dram", "pmem", "remote", "sharded"):
        ap.error(f"unknown pool backend {args.pool_backend!r}")
    if args.pool_readonly and args.pool_backend != "remote":
        ap.error("--pool-readonly: a read-only tenant needs "
                 "--pool-backend remote")
    if args.prompt_len < 1 or args.new_tokens < 1:
        ap.error("--prompt-len and --new-tokens must be at least 1")
    device = resolve_device(args.device)
    if args.pool_backend:
        pool_main(args)
        return

    cfg = get_arch(args.arch, smoke=True).model
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = get_api(cfg).init(gen, cfg)
    batch = make_batches(cfg, args.batch, args.prompt_len, device=device).next(0)
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    stats = {}
    toks = greedy_generate(cfg, params, batch["tokens"], args.new_tokens,
                           extras=extras, stats=stats)
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
