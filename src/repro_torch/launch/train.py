"""Training entry point (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm1 --smoke \
        --steps 100 [--strict] [--device cuda|cpu]

Runs the relaxed (paper) schedule by default, on the card; ``--device cpu``
runs the kernels' plain versions on the CPU. Checkpointing
(``--ckpt-dir/--resume/--pool-*``) is not ported yet.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.configs import DLRM_IDS, get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.data.lookahead import LookaheadIterator
from repro_torch.data.synthetic import DLRMBatches
from repro_torch.training import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-rm1", choices=DLRM_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--strict", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--embed-lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke).model
    tc = TrainConfig(learning_rate=args.lr, embed_learning_rate=args.embed_lr)
    batches = LookaheadIterator(DLRMBatches(cfg, args.batch, seed=0,
                                            device=device), cfg, depth=2)
    t0 = time.time()

    def on_metrics(n, m):
        if n % 10 == 0:
            print(f"[train] step {n:5d} loss {float(m['loss']):.4f} "
                  f"({(time.time()-t0):.1f}s)")

    _, losses = train_loop.train(cfg, tc, batches, args.steps,
                                 relaxed=not args.strict,
                                 on_metrics=on_metrics, device=device)
    print(f"[train] done on {device}: {len(losses)} steps, "
          f"final loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
