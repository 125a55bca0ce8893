"""End-to-end example (counterpart of the JAX package's
``examples/train_dlrm_e2e.py``): train a ~100M-parameter DLRM (the paper's
model class) with the whole stack on the port: the relaxed lookup schedule,
the lookahead data feed, and the two-tier asynchronous checkpoint into a
pmem pool (undo-logged embeddings every step, the dense params every 20).
Halfway it stops as if it had crashed, recovers from the pool file and
resumes. At the end the loss must have fallen: the run's first batches,
evaluated with the final params, give a lower loss than when the run
trained on them. (The labels are coin flips, so over a short run the
training loss itself drifts by less than its batch-to-batch spread; the
same batches remove that spread.)

    PYTHONPATH=src python -m repro_torch.examples.train_dlrm_e2e \\
        [--steps 300] [--batch 256] [--device cuda|cpu] [--work-dir DIR]
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import CheckpointConfig, ModelConfig, TrainConfig
from repro_torch.core.checkpoint import recovery
from repro_torch.core.checkpoint.manager import CheckpointManager
from repro_torch.data.lookahead import LookaheadIterator
from repro_torch.data.synthetic import make_batches
from repro_torch.models.registry import get_api
from repro_torch.training import state as st
from repro_torch.training import train_loop


def hundred_m_config() -> ModelConfig:
    """~100M params: 20 tables x 150k rows x 32 dims (96M embedding params,
    the pool tier) + bottom/top MLPs (0.15M dense params)."""
    return get_arch("dlrm-rm1").model.replace(
        dlrm_rows_per_table=150_000, dlrm_num_sparse=8,
        dlrm_bottom_mlp=(13, 512, 256, 32), dlrm_top_mlp=(64, 1),
        dtype="float32", remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    ap.add_argument("--work-dir", default=None,
                    help="where the checkpoint's pool file goes (a temporary "
                         "directory inside it, removed at the end)")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be at least 2 (a crash at half, then a resume)")
    device = resolve_device(args.device)

    cfg = hundred_m_config()
    n = cfg.param_counts()
    print(f"== DLRM e2e on {device}: {n['total']/1e6:.1f}M params "
          f"({n['embedding']/1e6:.1f}M in the embedding pool) ==")
    work = tempfile.mkdtemp(prefix="dlrm-e2e-", dir=args.work_dir)
    try:
        cc = CheckpointConfig(directory=work, dense_interval=20)
        tc = TrainConfig(learning_rate=3e-4, embed_learning_rate=0.02,
                         checkpoint=cc)
        t0 = time.time()

        def report(n, m):
            if n % 25 == 0:
                print(f"  step {n:4d}  loss {float(m['loss']):.4f}  "
                      f"({time.time() - t0:.1f}s)")

        half = args.steps // 2
        state = train_loop.init_state(cfg, tc, device)
        mgr = CheckpointManager(cfg, cc, embed_init=state["embed"])
        data = LookaheadIterator(make_batches(cfg, args.batch, 0, seed=0,
                                              device=device), cfg, depth=2)
        _, losses_a = train_loop.train(cfg, tc, data, half, relaxed=True,
                                       state=state, ckpt_manager=mgr,
                                       on_metrics=report, device=device)
        mgr.close()
        print(f"-- simulated crash at step {half}; ckpt stats: {mgr.stats}")
        del state, mgr

        rec = recovery.recover(work)
        print(f"-- recovered: embeddings@{rec.mirror_step} "
              f"dense@{rec.dense_step} gap={rec.gap} "
              f"rolled_back={rec.rolled_back}")
        state, resume = recovery.resume_train_state(
            rec, train_loop.init_state(cfg, tc, device))
        mgr = CheckpointManager(cfg, cc, pool=rec.pool)
        mgr.init_mirror(state["embed"], step=rec.mirror_step)
        data = LookaheadIterator(make_batches(cfg, args.batch, 0, seed=0,
                                              device=device), cfg, depth=2,
                                 start_step=resume)
        state, losses_b = train_loop.train(cfg, tc, data, args.steps - resume,
                                       relaxed=True, state=state,
                                       start_step=resume, ckpt_manager=mgr,
                                       on_metrics=report, device=device)
        print(mgr.pool.metrics.report())
        mgr.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    losses = losses_a + losses_b
    k = min(10, len(losses) // 2)     # the run's first k batches
    data = make_batches(cfg, args.batch, 0, seed=0, device=device)
    with torch.no_grad():
        now = np.mean([float(get_api(cfg).loss(st.params_of(state), cfg,
                                               data.next(n)))
                       for n in range(k)])
    first = np.mean(losses[:k])
    print(f"== done: {len(losses)} steps in {time.time() - t0:.1f}s; training "
          f"loss of the first and last {k} steps {first:.4f}, "
          f"{np.mean(losses[-k:]):.4f}; the first {k} batches' loss now "
          f"{now:.4f} ==")
    if not now < first:
        raise SystemExit(f"the loss did not fall: {first:.4f} -> {now:.4f}")


if __name__ == "__main__":
    main()
