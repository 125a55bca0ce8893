"""Where a training step's, or a serving step's, time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.trace_step --full --batch 128 \
        [--arch dlrm-rm1] [--steps 5] [--strict]
    PYTHONPATH=src python -m repro_torch.launch.trace_step --full \
        --arch tinyllama-1.1b --batch 4 --prompt-len 1024 [--steps 5]
    PYTHONPATH=src python -m repro_torch.launch.trace_step --full \
        --arch tinyllama-1.1b --train --batch 4 --seq 1024 [--steps 3] [--strict]

(``--arch`` also takes the other LM ids the port registers, as
``launch.serve`` and ``launch.train`` do; qwen2-vl-7b's and whisper-base's
prompts carry their batch's vision embeds or frames.) For a DLRM id, or an LM id
with ``--train``: makes every batch first
(set-up), runs one warm-up step, then profiles ``--steps`` training steps.
For an LM id otherwise: runs one warm-up generation, then profiles one
prefill of the prompt and ``--steps`` greedy decode steps after it, each
part on its own. Each profile (``torch.profiler``, CPU and CUDA activity)
prints the wall time per step, the device time per step of each kernel
(largest first) and of each family of kernels (the port's own by function,
cuBLAS matmuls, the rest), the kernel launches per step, and the device's
busy share: summed kernel time over wall time. Runs on the card unless
``--device cpu`` is given; on the CPU (a check that the path runs, with no
device time) the profile lists the host's operators by self time in place
of the kernels.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.data.lookahead import LookaheadIterator
from repro_torch.data.synthetic import make_batches
from repro_torch.models.registry import get_api
from repro_torch.training import train_loop
from repro_torch.training.serve_loop import greedy_generate


def _family(kernel: str) -> str:
    """The port's own kernels (top-level anonymous namespace in csrc/) by
    function name, cuBLAS's matmuls, and everything else (PyTorch's
    elementwise, reduction and copy kernels)."""
    own = "void (anonymous namespace)::"
    if kernel.startswith(own):
        return kernel[len(own):].split("<")[0].split("(")[0]
    if any(w in kernel.lower() for w in ("nvjet", "gemm", "cutlass")):
        return "cuBLAS matmuls"
    return "other: elementwise, reductions, copies"


@contextlib.contextmanager
def _trace(title: str, steps: int, device):
    """Profiles the body (``steps`` steps of work) and prints its breakdown."""
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = {}
    for e in prof.key_averages():
        if cuda and e.device_type == DeviceType.CUDA:
            kernels[e.key] = (e.self_device_time_total / 1e3 / steps, e.count)
        elif not cuda and e.device_type == DeviceType.CPU:
            kernels[e.key] = (e.self_cpu_time_total / 1e3 / steps, e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    print(f"[trace] {title} on {device}: wall {wall_ms:.3f} ms/step")
    busy = "device busy" if cuda else "host operators' self time (no device)"
    print(f"[trace] {busy} {busy_ms:.3f} ms/step, "
          f"busy share {busy_ms / wall_ms:.3f}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[trace] {ms:9.4f} ms/step  x{n / steps:g}  {name[:90]}")
    families = {}
    for name, (ms, n) in kernels.items():
        f = families.setdefault(_family(name), [0.0, 0])
        f[0] += ms
        f[1] += n / steps
    for name, (ms, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"[trace] family {ms:9.4f} ms/step  x{n:g}  {name}")
    print(json.dumps({"part": title, "wall_ms": wall_ms, "busy_ms": busy_ms,
                      "kernels_per_step": sum(n for _, n in kernels.values())
                      / steps}))


def _trace_train(cfg, args, device) -> None:
    tc = TrainConfig(embed_learning_rate=0.05)
    relaxed = not args.strict
    batches = LookaheadIterator(make_batches(cfg, args.batch, args.seq,
                                             device=device), cfg,
                                depth=args.steps + 2)
    state, _ = train_loop.train(cfg, tc, batches, 1, relaxed=relaxed,
                                device=device)          # warm-up step
    shape = f"batch {args.batch}" + ("" if cfg.arch_type == "dlrm"
                                     else f" seq {args.seq}")
    with _trace(f"{cfg.name} {shape} {'relaxed' if relaxed else 'strict'}",
                args.steps, device):
        train_loop.train(cfg, tc, batches, args.steps, relaxed=relaxed,
                         state=state, start_step=1)


def _trace_serve(cfg, args, device) -> None:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = get_api(cfg).init(gen, cfg)
    B, S = args.batch, args.prompt_len
    batch = make_batches(cfg, B, S, device=device).next(0)
    prompt = batch["tokens"]
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    greedy_generate(cfg, params, prompt, 2, extras=extras)              # warm-up
    parts = {"prefill": (f"{cfg.name} prefill batch {B} prompt {S}", 1),
             "decode": (f"{cfg.name} decode batch {B} from position {S}",
                        args.steps)}
    greedy_generate(cfg, params, prompt, args.steps + 1, extras=extras,
                    part=lambda name: _trace(*parts[name], device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-rm1", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--train", action="store_true",
                    help="LM: trace training steps instead of serving")
    ap.add_argument("--strict", action="store_true",
                    help="training: trace strict steps instead of relaxed ones")
    ap.add_argument("--seq", type=int, default=1024,
                    help="LM training: tokens per sequence")
    ap.add_argument("--prompt-len", type=int, default=1024,
                    help="LM: prompt tokens of the traced prefill")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke).model
    if cfg.arch_type == "dlrm" or args.train:
        _trace_train(cfg, args, device)
    else:
        _trace_serve(cfg, args, device)


if __name__ == "__main__":
    main()
