"""Where a training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.trace_step --full --batch 128 \
        [--arch dlrm-rm1] [--steps 5] [--strict]

Makes every batch first (set-up), runs one warm-up step, then times
``--steps`` steps with ``torch.profiler`` (CPU and CUDA activity). Prints the
wall time per step, the device time per step of each kernel (largest
first), and the device's busy share: summed kernel time over wall time.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

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
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--strict", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = get_arch(args.arch, smoke=args.smoke).model
    tc = TrainConfig(embed_learning_rate=0.05)
    relaxed = not args.strict
    batches = LookaheadIterator(DLRMBatches(cfg, args.batch, device=device), cfg,
                                depth=args.steps + 2)
    state, _ = train_loop.train(cfg, tc, batches, 1, relaxed=relaxed,
                                device=device)          # warm-up step
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_loop.train(cfg, tc, batches, args.steps, relaxed=relaxed,
                         state=state, start_step=1)
        torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = (e.self_device_time_total / 1e3 / args.steps, e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    print(f"[trace] {cfg.name} batch {args.batch} "
          f"{'relaxed' if relaxed else 'strict'} on {device}: "
          f"wall {wall_ms:.3f} ms/step")
    print(f"[trace] device busy {busy_ms:.3f} ms/step, "
          f"busy share {busy_ms / wall_ms:.3f}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        print(f"[trace] {ms:9.4f} ms/step  x{n / args.steps:g}  {name[:90]}")
    print(json.dumps({"wall_ms": wall_ms, "busy_ms": busy_ms,
                      "kernels_per_step": sum(n for _, n in kernels.values())
                      / args.steps}))


if __name__ == "__main__":
    main()
