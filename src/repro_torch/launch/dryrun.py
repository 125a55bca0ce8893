"""The dry run's sharding rules (counterpart of ``build_rules`` in
``repro.launch.dryrun``, ``src/repro/launch/dryrun.py:81-109``).

``build_rules(bundle, shape, mesh)`` gives the activation rules, the
weight rules and the data-parallel axes of one (arch x shape) cell, as the
reference's does: batch over the data axes, heads and kv heads over
``model``, the sequence over ``model`` for training under the Megatron-SP
profile (``ShardingProfile.seq_shard_activations``), and for decode the
cache's sequence over ``model`` (batch > 1) or over every axis (batch 1).
Under these rules the port runs the dense decoders with dense tensor
parallelism (``distributed.tensor_parallel``; ``heads`` turns it on).

Two cases the port does not lay out raise ``NotImplementedError`` naming
ROADMAP queue 1 item 10(c): a profile with ``fsdp`` (the weights'
``embed`` dimension over ``data`` as well: granite, jamba, qwen3-moe,
arctic), and heads or kv heads that ``model`` does not divide (granite's
one kv head; the reference falls back to sharding the kv sequence there).

This module holds the rules only. The lowering of every cell and its
cost model (the reference's ``lower_train_cell``, ``lower_serve_cell``,
``launch/perf.py`` and ``utils/hlo.py``) come with ROADMAP's dry-run item,
rebuilt for the H100.
"""
from __future__ import annotations


def build_rules(bundle, shape, mesh):
    """(act_rules, weight_rules, dp) for ``bundle`` (an ``ArchBundle``) at
    ``shape`` (a ``ShapeConfig``) on ``mesh`` (a ``launch.mesh.Mesh``)."""
    prof, cfg = bundle.sharding, bundle.model
    axes = set(mesh.axis_names)
    tp = mesh.sizes.get("model", 1)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    if prof.fsdp:
        raise NotImplementedError(
            f"{cfg.name}: its profile shards the weights over data too (fsdp, "
            "w_embed over data), which the port does not lay out: ROADMAP queue 1 "
            "item 10(c)")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.num_heads} heads and {cfg.num_kv_heads} kv heads over "
            f"{tp} model ranks; the reference shards the kv sequence where the heads "
            "do not divide, which the port does not: ROADMAP queue 1 item 10(c)")
    act_rules = {"batch": dp, "heads": "model", "kv_heads": "model", "kv_seq": None}
    if prof.seq_shard_activations and shape.kind == "train":
        act_rules["seq"] = "model"
    if shape.kind == "decode":
        if shape.global_batch == 1:
            # long-context: every axis carries cache sequence
            act_rules["cache_seq"] = tuple(mesh.axis_names)
            act_rules["batch"] = None
        else:
            act_rules["cache_seq"] = "model"
    return act_rules, {}, dp
