"""Quickstart (counterpart of the JAX package's ``examples/quickstart.py``):
train a smoke LM on the relaxed schedule, check it against the strict one,
then decode with the trained weights.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import TrainConfig
from repro_torch.data.synthetic import make_batches
from repro_torch.training import state as st
from repro_torch.training import train_loop
from repro_torch.training.serve_loop import greedy_generate

ARCH = "tinyllama-1.1b"   # its smoke-size variant


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(ARCH, smoke=True).model
    tc = TrainConfig(learning_rate=1e-3, embed_learning_rate=0.05)

    print(f"== {ARCH} on {device} (reduced config: {cfg.num_layers}L "
          f"d={cfg.d_model}) ==")
    data = make_batches(cfg, batch=8, seq=32, device=device)
    state, losses = train_loop.train(cfg, tc, data, 20, relaxed=True,
                                     device=device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps "
          "(relaxed schedule: every lookup prefetched + corrected)")

    # equivalence with the dependent schedule (paper Fig. 8): a row-gather
    # model's relaxed losses are the strict ones bit for bit
    _, strict_losses = train_loop.train(cfg, tc, data, 20, relaxed=False,
                                        device=device)
    same = losses == strict_losses
    print("strict == relaxed:", same)
    if not same:
        raise SystemExit(f"relaxed {losses} != strict {strict_losses}")

    prompt = data.next(99)["tokens"][:2, :8]
    toks = greedy_generate(cfg, st.params_of(state), prompt, 8, max_seq=16)
    print("generated:", toks[0].tolist())


if __name__ == "__main__":
    main()
