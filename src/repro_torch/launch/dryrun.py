"""The dry run's sharding rules (counterpart of ``build_rules`` in
``repro.launch.dryrun``, ``src/repro/launch/dryrun.py:81-109``).

``build_rules(bundle, shape, mesh)`` gives the activation rules, the
weight rules and the data-parallel axes of one (arch x shape) cell, as the
reference's does: batch over the data axes, heads over ``model``, kv heads
over ``model`` where it divides them (else None: every model rank keeps
the kv heads whole), the sequence over ``model`` for training under the
Megatron-SP profile (``ShardingProfile.seq_shard_activations``), for
decode the cache's sequence over ``model`` (batch > 1) or over every axis
(batch 1), and under an ``fsdp`` profile the weight rule ``w_embed`` over
``data`` (ZeRO-3: the weights' ``embed`` dimension over ``data`` as well
as their heads or ffn dimension over ``model``; the experts' embed
dimension too, beside the experts over ``model``). Under these rules the
port runs the decoders of arch type transformer, dense and MoE, and jamba
with dense tensor parallelism (``distributed.tensor_parallel``; ``heads``
turns it on; the experts over the same axis, jamba's SSD heads split
over it) and FSDP (``distributed.fsdp``; ``w_embed`` turns it on): the
profiles of qwen3-moe-235b-a22b, arctic-480b and jamba-v0.1-52b (fsdp,
Megatron-SP) are exactly what their models run under. A context takes both
dicts as one: ``use_sharding(mesh, {**act_rules, **weight_rules})``.

Where ``model`` does not divide the kv heads (granite-20b's one) the
reference sets ``kv_heads`` None and keeps ``kv_seq`` None: each model
rank holds the kv heads whole. It shards the kv sequence over ``model``
(``kv_seq``) only where the *query* heads do not divide (arctic-480b's 56
heads at model 16). The port refuses that case with
``NotImplementedError``, ROADMAP queue 1 item 10(c).

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
    if cfg.num_heads % tp:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.num_heads} query heads over {tp} model ranks; the "
            "reference shards the kv sequence over model there (kv_seq, a partial "
            "softmax across the ranks), which the port does not: ROADMAP queue 1 "
            "item 10(c)")
    act_rules = {"batch": dp, "heads": "model",
                 "kv_heads": "model" if cfg.num_kv_heads % tp == 0 else None,
                 "kv_seq": None}
    if prof.seq_shard_activations and shape.kind == "train":
        act_rules["seq"] = "model"
    if shape.kind == "decode":
        if shape.global_batch == 1:
            # long-context: every axis carries cache sequence
            act_rules["cache_seq"] = tuple(mesh.axis_names)
            act_rules["batch"] = None
        else:
            act_rules["cache_seq"] = "model"
    weight_rules = {"w_embed": "data"} if prof.fsdp else {}
    return act_rules, weight_rules, dp
