"""Train state: params split into the dense tier and the embedding pool tier.

The layout is the JAX package's (``repro.training.state``), a plain dict.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves


def split_params(params: dict) -> tuple[dict, dict]:
    """(dense_tree, embed_tree). The 'embed' subtree is the pool tier."""
    dense = {k: v for k, v in params.items() if k != "embed"}
    return dense, params.get("embed", {})


def merge_params(dense: dict, embed: dict) -> dict:
    out = dict(dense)
    if embed:
        out["embed"] = embed
    return out


def make_state(params: dict, dense_opt, embed_opt) -> dict:
    """The state holds the caller's param tensors, not copies; training
    updates them in place (a caller that reuses a param tree clones it)."""
    dense, embed = split_params(params)
    return {
        "dense": dense,
        "embed": embed,
        "opt_dense": dense_opt.init(dense),
        "opt_embed": embed_opt.init(embed),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
        # relaxed-lookup carry: rows prefetched for the NEXT batch
        "prefetch": None,
    }


def params_of(state: dict) -> dict:
    return merge_params(state["dense"], state["embed"])
