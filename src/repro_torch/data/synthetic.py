"""Synthetic LM token streams and DLRM features (counterpart of
``repro.data.synthetic``).

The numpy RNG streams are the JAX package's, so both packages see
bit-identical batches from the same seed; the port emits torch tensors on
the device it is given.

DLRM sparse indices follow a zipf-like distribution (the paper's Criteo
Kaggle access skew); the hot-row skew is what makes consecutive-batch row
overlap, and hence the relaxed lookup's RAW hazard, realistic.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def zipf_indices(rng: np.random.Generator, shape, num_rows: int,
                 alpha: float = 1.05):
    """Zipf-distributed row ids in [0, num_rows) (Criteo-like skew)."""
    # inverse-CDF sampling on a truncated zipf
    ranks = np.arange(1, num_rows + 1, dtype=np.float64)
    probs = 1.0 / np.power(ranks, alpha)
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    u = rng.random(size=shape)
    idx = np.searchsorted(cdf, u)
    # scramble rank->row so hot rows are spread across shards
    perm_seed = np.uint64(num_rows * 2654435761 % (2**31))
    rows = (idx.astype(np.uint64) * np.uint64(2654435761)
            + perm_seed) % np.uint64(num_rows)
    return rows.astype(np.int32)


class LMBatches:
    """Deterministic synthetic LM token stream: zipf tokens over the vocab,
    labels the tokens shifted by one. qwen2-vl's batches add the stub
    vision embeds (B, S // 8, d) and the M-RoPE positions (3, B, S);
    whisper's the stub frame embeddings (B, S, d). They are drawn after the
    tokens from the same generator, as the reference draws them.

    As in the reference, a batch depends on (step, batch, seq) alone: the
    reference's seed argument never enters the draw, so there is none here.
    """

    def __init__(self, cfg, batch: int, seq: int, device="cuda"):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.device = resolve_device(device)

    def next(self, step: int) -> dict:
        rng = np.random.default_rng((hash((step, self.batch, self.seq))
                                     & 0x7FFFFFFF))
        B, S, d = self.batch, self.seq, self.cfg.d_model
        toks = zipf_indices(rng, (B, S + 1), self.cfg.vocab_size)
        out = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
        if self.cfg.arch_type == "qwen2vl":
            out["vision_embeds"] = rng.standard_normal(
                (B, max(1, S // 8), d)).astype(np.float32)
            out["positions3"] = np.broadcast_to(np.arange(S), (3, B, S)).copy()
        if self.cfg.arch_type == "whisper":
            out["frames"] = rng.standard_normal((B, S, d)).astype(np.float32)
        return {k: torch.from_numpy(v).to(self.device) for k, v in out.items()}


class DLRMBatches:
    """Synthetic DLRM batches with zipf sparse features.

    ``indices_for_step`` is separable from ``next``: the data pipeline knows
    batch N+1's indices before batch N finishes (the paper's batch-aware
    property, Figure 6).
    """

    def __init__(self, cfg, batch: int, seed: int = 0, alpha: float = 1.05,
                 device="cuda"):
        self.cfg, self.batch, self.seed, self.alpha = cfg, batch, seed, alpha
        self.device = resolve_device(device)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed * 1_000_003 + step))

    def indices_for_step(self, step: int) -> np.ndarray:
        """(B, T, L) int32, known in advance of the step's compute."""
        rng = self._rng(step)
        c = self.cfg
        return zipf_indices(rng, (self.batch, c.dlrm_num_tables,
                                  max(1, c.dlrm_num_sparse)),
                            c.dlrm_rows_per_table, self.alpha)

    def next(self, step: int) -> dict:
        rng = self._rng(step)
        c = self.cfg
        dense = rng.standard_normal((self.batch, c.dlrm_num_dense)) \
            .astype(np.float32)
        labels = (rng.random(self.batch) < 0.5).astype(np.float32)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in (("dense", dense),
                             ("sparse", self.indices_for_step(step)),
                             ("labels", labels))}


def make_batches(cfg, batch: int, seq: int, seed: int = 0, device="cuda"):
    """The id's batch stream; ``seed`` enters DLRM batches only (LMBatches)."""
    if cfg.arch_type == "dlrm":
        return DLRMBatches(cfg, batch, seed, device=device)
    return LMBatches(cfg, batch, seq, device=device)
