"""DLRM (counterpart of ``repro.models.dlrm``), RM1-RM4 configs.

bottom-MLP(dense features) -> z0
bag_lookup(sparse features) -> z1..zT   (the embedding-bag kernel)
feature interaction (pairwise dots) + concat -> top-MLP -> CTR logit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import embedding_ops
from repro_torch.models import layers


def _init_mlp_stack(gen, dims, dtype):
    return [{"w": layers.dense_init(gen, dims[i], dims[i + 1], dtype),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=gen.device)}
            for i in range(len(dims) - 1)]


def _mlp_stack(ps, x, final_act=True):
    for i, p in enumerate(ps):
        x = x @ p["w"] + p["b"]
        if i < len(ps) - 1 or final_act:
            x = torch.relu(x)
    return x


def init_dlrm(gen: torch.Generator, cfg, keep=None):
    """Random params on ``gen``'s device: tables ~ N(0, 1/d), MLPs uniform.
    ``keep(path, leaf)``, if given, cuts the tables once drawn
    (``distributed.sharding.keep_shard``: a rank's rows)."""
    dt = cfg.activation_dtype
    d_emb = cfg.dlrm_bottom_mlp[-1]
    T, R = cfg.dlrm_num_tables, cfg.dlrm_rows_per_table
    tables = torch.empty((T, R, d_emb), dtype=dt, device=gen.device)
    for t in range(T):   # one table's f32 draw at a time bounds the peak memory
        tables[t] = (torch.randn((R, d_emb), generator=gen, device=gen.device)
                     / math.sqrt(d_emb)).to(dt)
    if keep is not None:
        tables = keep("embed/emb_tables", tables)
    n_feat = T + 1
    n_inter = n_feat * (n_feat - 1) // 2
    top_in = d_emb + n_inter
    top_dims = (top_in,) + tuple(cfg.dlrm_top_mlp)
    return {
        "embed": {"emb_tables": tables},
        "bottom": _init_mlp_stack(gen, cfg.dlrm_bottom_mlp, dt),
        "top": _init_mlp_stack(gen, top_dims, dt),
    }


def forward(params, cfg, batch):
    """batch: dense (B, n_dense) float; sparse (B, T, L) int32 -> logits (B,)."""
    dense = batch["dense"].to(cfg.activation_dtype)
    z0 = _mlp_stack(params["bottom"], dense)                  # (B, d_emb)
    if batch.get("embed_rows") is not None:
        # relaxed lookup: reduced bag vectors prefetched at batch N-1
        bags = batch["embed_rows"]
    else:
        bags = embedding_ops.bag_lookup(params["embed"]["emb_tables"], batch["sparse"],
                                        rows=cfg.dlrm_rows_per_table)   # (B, T, d_emb)
    feats = torch.cat([z0[:, None, :], bags.to(z0.dtype)], dim=1)
    inter = torch.bmm(feats, feats.transpose(1, 2))           # (B, F, F)
    iu = torch.triu_indices(feats.shape[1], feats.shape[1], offset=1,
                            device=feats.device)   # row-major, as jnp.triu_indices
    inter = inter[:, iu[0], iu[1]]                            # (B, F(F-1)/2)
    x = torch.cat([z0, inter.to(z0.dtype)], dim=-1)
    return _mlp_stack(params["top"], x, final_act=False)[:, 0]


def bce_loss(params, cfg, batch):
    logit = forward(params, cfg, batch).float()
    y = batch["labels"].float()
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


lm_loss = bce_loss  # registry-uniform name
