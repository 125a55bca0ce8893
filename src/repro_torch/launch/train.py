"""Training entry point (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm1 --smoke \\
        --steps 100 [--strict] [--device cuda|cpu] \\
        [--ckpt-dir /tmp/ckpt [--resume]] [--pool-backend pmem|dram] \\
        [--pool-compress none|zlib|int8] [--dense-interval K]
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --seq 64 [... the same options]

``--arch`` takes the DLRM ids, the dense transformer ids (tinyllama-1.1b,
qwen3-0.6b) and rwkv6-3b; an LM trains on synthetic zipf token batches of
``--batch`` x ``--seq``. Runs the relaxed (paper) schedule by default, on the card;
``--device cpu`` runs the kernels' plain versions on the CPU. With
``--ckpt-dir`` every relaxed step is checkpointed into the emulated pool by
the two-tier manager; ``--resume`` recovers from that directory and goes on
from the step after the last consistent one. The remote and sharded pool
backends are not ported and raise.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.configs import DLRM_IDS, LM_IDS, get_arch
from repro_torch.configs.base import CheckpointConfig, TrainConfig
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.data.lookahead import LookaheadIterator
from repro_torch.data.synthetic import make_batches
from repro_torch.pool.device import NOT_PORTED, PoolError, check_backend
from repro_torch.training import train_loop


# the ids the port trains: DLRM, the dense transformers and RWKV-6
TRAIN_IDS = DLRM_IDS + [a for a in LM_IDS if get_arch(a, smoke=True).model.arch_type
                        in ("transformer", "rwkv6")]


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
                    choices=["dram", "pmem", *NOT_PORTED],
                    help="emulated memory-pool backend for checkpoints "
                         f"({', '.join(NOT_PORTED)}: not ported yet, raises)")
    ap.add_argument("--pool-compress", choices=["none", "zlib", "int8"],
                    default="zlib",
                    help="pool-side compression for undo payloads and dense "
                         "snapshot blobs (int8 is lossy: relaxed rollback)")
    ap.add_argument("--dense-interval", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--embed-lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)
    try:
        check_backend(args.pool_backend)
    except PoolError as e:
        ap.error(str(e))
    if args.resume and args.pool_backend == "dram":
        ap.error("--resume needs a pool that survives process death; "
                 "the dram backend is volatile: use --pool-backend pmem")

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke).model
    ckpt = CheckpointConfig(enabled=bool(args.ckpt_dir),
                            directory=args.ckpt_dir or "/tmp/repro_ckpt",
                            dense_interval=args.dense_interval,
                            pool_backend=args.pool_backend,
                            pool_compress=args.pool_compress)
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
                  f"({(time.time()-t0):.1f}s)")

    try:
        _, losses = train_loop.train(cfg, tc, batches, args.steps,
                                     relaxed=not args.strict, state=state,
                                     start_step=start, ckpt_manager=mgr,
                                     on_metrics=on_metrics, device=device)
    finally:
        if mgr is not None:
            mgr.pool.close()
    print(f"[train] done on {device}: {len(losses)} steps, "
          f"final loss {losses[-1]:.4f}")
    if mgr is not None:
        print(f"[train] checkpoint stats: {mgr.stats}")
        print(mgr.pool.metrics.report())


if __name__ == "__main__":
    main()
