"""Training entry point (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm1 --smoke \\
        --steps 100 [--strict] [--device cuda|cpu] \\
        [--ckpt-dir /tmp/ckpt [--resume]] \\
        [--pool-backend pmem|dram|remote|sharded] \\
        [--pool-addr unix:/path|tcp:host:port] [--pool-tenant T] \\
        [--pool-quota BYTES] [--pool-secret S] \\
        [--pool-shards A1,A2,... [--pool-placement dom=i,...] \\
         [--pool-rebalance HIGH] [--pool-replica I] [--pool-ckpt-replica I] \\
         [--pool-manifest-quorum]] \\
        [--pool-compress none|zlib|int8] [--dense-interval K]
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --seq 64 [... the same options]

``--arch`` takes the DLRM ids and every LM id the port registers: the
dense transformers (tinyllama-1.1b, qwen3-0.6b, llama3.2-3b, granite-20b),
the MoE ones (qwen3-moe-235b-a22b, arctic-480b), rwkv6-3b, jamba-v0.1-52b,
qwen2-vl-7b and whisper-base; an LM trains on synthetic zipf token batches
of ``--batch`` x ``--seq`` (with stub vision embeds for qwen2-vl, stub
audio frames for whisper). whisper-base's head is tied to its token table,
so every step updates every row, and ``--ckpt-dir`` refuses it (tier-E
logs the rows a batch touches).
``--full`` builds the whole published model, which must fit on the card
with its optimizer state: ``chip_smoke.py`` trains tinyllama-1.1b,
rwkv6-3b and llama3.2-3b so on an 80 GB H100, and granite-20b,
qwen3-moe-235b-a22b, arctic-480b and jamba-v0.1-52b at the smoke size. Runs the relaxed (paper) schedule by default, on the card;
``--device cpu`` runs the kernels' plain versions on the CPU. With
``--ckpt-dir`` every relaxed step is checkpointed into the emulated pool by
the two-tier manager; ``--resume`` recovers from that directory and goes on
from the step after the last consistent one. ``--pool-backend remote``
checkpoints into a memory node in another process (start one with
``python -m repro_torch.pool.server --addr unix:/tmp/pool.sock --backend
pmem --path /tmp/pool.img``) as tenant ``--pool-tenant``; at the end the
CLI prints the tenant's counters as the node attributed them.
``--pool-backend sharded --pool-shards A1,A2,...`` spreads the checkpoint
over several such nodes (``repro_torch.pool.sharded``), with pins, a
capacity rebalancer, a read replica of the mirror, a commit-coupled replica
of the undo ring and manifest, and a 2-of-3 manifest quorum on request.
Every 10th step's line gives the loss and the kernels' launch counts so
far.
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch import resolve_device
from repro_torch.configs import DLRM_IDS, LM_IDS, get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.data.lookahead import LookaheadIterator
from repro_torch.data.synthetic import make_batches
from repro_torch.kernels import embedding_bag, gather_rows, scatter_update
from repro_torch.training import train_loop


# the ids the port trains: DLRM and every registered LM
TRAIN_IDS = DLRM_IDS + LM_IDS


def launch_counts() -> dict:
    """The training path's kernel launches so far in this process."""
    return {"embedding_bag": embedding_bag.launches,
            "scatter_update": scatter_update.launches,
            "scatter_update_logged": scatter_update.launches_logged,
            "gather_rows": gather_rows.launches}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-rm1", choices=TRAIN_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64,
                    help="LM: tokens per sequence (DLRM ignores it)")
    ap.add_argument("--strict", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--pool-backend", default="pmem",
                    choices=["dram", "pmem", "remote", "sharded"],
                    help="emulated memory-pool backend for checkpoints")
    ap.add_argument("--pool-addr", default="",
                    help="remote backend: pool-server address "
                         "(unix:/path or tcp:host:port)")
    ap.add_argument("--pool-shards", default="",
                    help="sharded backend: comma-separated pool-server "
                         "addresses (one per memory node)")
    ap.add_argument("--pool-placement", default="",
                    help="sharded backend: explicit domain pins, e.g. "
                         "'manifest=1,dense=1' (unpinned domains hash "
                         "deterministically over the shard list)")
    ap.add_argument("--pool-tenant", default="default",
                    help="remote backend: tenant namespace on the pool node")
    ap.add_argument("--pool-quota", type=int, default=0,
                    help="remote backend: byte quota (0 = unlimited)")
    ap.add_argument("--pool-secret",
                    default=os.environ.get("REPRO_POOL_SECRET", ""),
                    help="shared secret for the memory-node tcp handshake "
                         "(HMAC challenge; env REPRO_POOL_SECRET; unix "
                         "sockets are exempt)")
    ap.add_argument("--pool-compress", choices=["none", "zlib", "int8"],
                    default="zlib",
                    help="pool-side compression for undo payloads and dense "
                         "snapshot blobs (int8 is lossy: relaxed rollback)")
    ap.add_argument("--pool-rebalance", type=float, default=0.0,
                    metavar="HIGH",
                    help="sharded backend: capacity-watermark rebalancing; "
                         "when a node's used/capacity crosses HIGH (e.g. "
                         "0.75), live-migrate its largest unpinned domain "
                         "group to the emptiest node (0 = off)")
    ap.add_argument("--pool-replica", type=int, default=-1, metavar="SHARD",
                    help="sharded backend: keep a read replica of the "
                         "embedding mirror on this shard index, refreshed "
                         "at the commit watermark (-1 = off)")
    ap.add_argument("--pool-ckpt-replica", type=int, default=-1,
                    metavar="SHARD",
                    help="sharded backend: commit-coupled replica of the "
                         "checkpoint domains (undo-log + manifest) on this "
                         "shard index; survives the permanent loss of the "
                         "primary by replica promotion (-1 = off)")
    ap.add_argument("--pool-manifest-quorum", action="store_true",
                    help="sharded backend (3 nodes or more): keep 3 "
                         "manifest copies on distinct shards; recovery "
                         "takes the 2-of-3 majority by sealed seq")
    ap.add_argument("--dense-interval", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--embed-lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)
    if args.resume and args.pool_backend == "dram":
        ap.error("--resume needs a pool that survives process death; "
                 "the dram backend is volatile: use --pool-backend "
                 "pmem or remote")
    if args.pool_backend == "remote" and not args.pool_addr:
        ap.error("--pool-backend remote needs --pool-addr "
                 "(start one: python -m repro_torch.pool.server --addr ...)")
    if args.pool_backend == "sharded" and not args.pool_shards:
        ap.error("--pool-backend sharded needs --pool-shards addr1,addr2,... "
                 "(one pool server per memory node)")

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke).model
    ckpt = CheckpointConfig(enabled=bool(args.ckpt_dir),
                            directory=args.ckpt_dir or "/tmp/repro_ckpt",
                            dense_interval=args.dense_interval,
                            pool_backend=args.pool_backend,
                            pool_addr=args.pool_addr,
                            pool_shards=args.pool_shards,
                            pool_placement=args.pool_placement,
                            pool_tenant=args.pool_tenant,
                            pool_quota=args.pool_quota,
                            pool_compress=args.pool_compress,
                            pool_rebalance=args.pool_rebalance,
                            pool_replica=args.pool_replica,
                            pool_ckpt_replica=args.pool_ckpt_replica,
                            pool_manifest_quorum=args.pool_manifest_quorum,
                            pool_secret=args.pool_secret)
    tc = TrainConfig(learning_rate=args.lr, embed_learning_rate=args.embed_lr,
                     checkpoint=ckpt)

    state = train_loop.init_state(cfg, tc, device)
    start = 0
    mgr = None
    if args.ckpt_dir:
        if args.resume:
            rec = recovery.recover(args.ckpt_dir)
            state, start = recovery.resume_train_state(rec, state)
            print(f"[train] resumed at step {start} "
                  f"(embed@{rec.mirror_step}, dense@{rec.dense_step}, "
                  f"gap={rec.gap}, rolled_back={rec.rolled_back})")
            mgr = CheckpointManager(cfg, ckpt, pool=rec.pool)
            mgr.init_mirror(state["embed"], step=rec.mirror_step)
        else:
            mgr = CheckpointManager(cfg, ckpt, embed_init=state["embed"])
    batches = LookaheadIterator(make_batches(cfg, args.batch, args.seq, seed=0,
                                             device=device), cfg, depth=2,
                                start_step=start)
    t0 = time.time()

    def on_metrics(n, m):
        if n % 10 == 0:
            print(f"[train] step {n:5d} loss {float(m['loss']):.4f} "
                  f"({(time.time()-t0):.1f}s) launches {launch_counts()}",
                  flush=True)

    try:
        _, losses = train_loop.train(cfg, tc, batches, args.steps,
                                     relaxed=not args.strict, state=state,
                                     start_step=start, ckpt_manager=mgr,
                                     on_metrics=on_metrics, device=device)
        print(f"[train] done on {device}: {len(losses)} steps, "
              f"final loss {losses[-1]:.4f}")
        if mgr is not None:
            print(f"[train] checkpoint stats: {mgr.stats}")
            # a remote pool's counters are the tenant's, as the node
            # attributed them
            print(mgr.pool.metrics.report())
    finally:
        if mgr is not None:
            mgr.pool.close()


if __name__ == "__main__":
    main()
