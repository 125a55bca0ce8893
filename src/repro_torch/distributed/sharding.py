"""Logical-axis sharding rules and per-arch parameter specs (counterpart of
``repro.distributed.sharding``).

The rules map *logical* axis names (batch, vocab, experts, cache_seq ...)
to mesh axes. ``use_sharding(mesh, rules)`` installs a ``ShardingContext``
(thread-local) that the islands read: the near-data lookup and bag
(``core/embedding_ops.py``), context-parallel decode
(``distributed/context_parallel.py``), expert-parallel MoE
(``models/moe.py``) and dense tensor parallelism
(``distributed/tensor_parallel.py``). Outside a context every call runs
unsharded.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
dimension, each a mesh axis name, a tuple of names or None; ``()`` is
replicated.

Eager PyTorch has no layout constraint, so ``constrain`` is the identity:
the modules hand each rank what it needs themselves. Weights are held by
their spec: ``local_shard`` takes a rank's part of a leaf (what
``jax.device_put`` with a ``NamedSharding`` does), ``shard_params`` a
tree's, and ``keep_shard`` gives the inits the same cut leaf by leaf, so
that a rank never holds the whole model. Two kinds of leaf are held
sharded (``held_spec``):
  * the islands' leaves (``ISLAND_LEAVES``: the token table's rows over
    ``vocab``, DLRM's table rows over ``table_rows``, the experts over
    ``experts``, and their embed dimension over ``data`` under a
    ``w_embed`` rule), always;
  * the decoders' projections, the router and the head (``TP_LEAVES``:
    ``wq|wk|wv|wi|wg`` (embed, heads or ffn), ``wo`` (heads or ffn,
    embed), arctic's dense residual ``moe/dense/*`` likewise, ``router``
    (embed, None), mamba's ``in_proj`` (embed, ffn), ``out_proj`` (ffn,
    embed), ``bc_proj`` and ``dt_proj`` (ffn, None), ``lm_head`` (embed,
    vocab)), where the rules name ``heads`` (dense tensor parallelism: the
    heads, ffn and vocab dimensions over ``model``) or ``w_embed`` (FSDP:
    the embed dimension over ``data`` too), by the reference's spec:
    ``param_specs``' entry downgraded where
    the mesh does not divide it, as ``check_divisibility`` places it (XLA
    derives both from that placement in the reference;
    ``launch.dryrun.build_rules`` writes the rules). Granite's
    (6144, 128) ``wk`` is then a (data, model) block. ``DEFAULT_RULES``
    leave ``heads``, ``kv_heads`` and ``ffn`` out (the reference's name
    ``model`` for them), so that a context is tensor-parallel exactly when
    its rules name ``heads``; without either rule every other leaf is held
    whole on every rank, as the serving and DLRM layouts under a mesh do.
    A layer takes a held leaf to its compute layout at its use
    (``distributed.fsdp``).

A context's rules are the reference's activation and weight rules in one
dict (``{**act_rules, **weight_rules}``; their names do not clash, and
``spec_for`` reads the weight names among them).

A batch is split by ``shard_batch``: each rank keeps its slice of the
leading batch dimension over the ``batch`` rule's axes (the data-parallel
axes), as the reference's ``batch_shardings`` lays a batch out
(``positions3`` on its dimension 1).
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Optional

from repro_torch.tree import tree_map_with_path

_state = threading.local()


DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,              # "model" under Megatron-SP profile
    "embed": None,
    # no heads / kv_heads / ffn rule (the reference's: "model"): a context
    # is tensor-parallel exactly when its rules name heads
    "vocab": "model",         # the disaggregated pool axis
    "experts": "model",       # EP
    "expert_ffn": None,
    "cache_seq": None,        # "data" under context-parallel decode
    "table_rows": "model",    # DLRM embedding pool rows
}


def _in_mesh(ax, mesh_axes):
    """``ax`` (a name or a tuple of names) less the names not in the mesh;
    None if nothing is left, the name if one is (as ``PartitionSpec``
    writes it)."""
    if ax is None:
        return None
    if isinstance(ax, (tuple, list)):
        left = tuple(a for a in ax if a in mesh_axes)
        return (left[0] if len(left) == 1 else left) or None
    return ax if ax in mesh_axes else None


class ShardingContext:
    """The rules in force (``rules``: the defaults updated by the caller's).
    ``tp``: the mesh axis of dense tensor parallelism, the ``heads`` rule's
    (None: no such rule); ``fsdp``: the mesh axis of the ``w_embed``
    weight rule (None: no such rule); without either the dense leaves are
    held whole. ``sp``: whether the residual stream is sharded by sequence
    over the TP axis (a ``seq`` rule naming it, the Megatron-SP profile)."""

    def __init__(self, mesh, rules: dict[str, Any]):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        self.rules.update(rules or {})
        self.mesh_axes = set(mesh.axis_names)
        self.tp = tp_axis(self.rules, self.mesh_axes)
        self.fsdp = fsdp_axis(self.rules, self.mesh_axes)
        self.sp = self.tp is not None and self.axes("seq") == self.tp

    def spec(self, logical: tuple[Optional[str], ...]) -> tuple:
        return tuple(_in_mesh(self.rules.get(name) if name else None, self.mesh_axes)
                     for name in logical)

    def axes(self, name: str):
        """The mesh axes the rule ``name`` names, those in the mesh only
        (a name, a tuple of names, or None)."""
        return _in_mesh(self.rules.get(name), self.mesh_axes)


@contextlib.contextmanager
def use_sharding(mesh, rules: dict[str, Any] | None = None):
    prev = getattr(_state, "ctx", None)
    _state.ctx = ShardingContext(mesh, rules or {})
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


def current() -> Optional[ShardingContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def restore(ctx: Optional[ShardingContext]):
    """Installs ``ctx``, a context taken by ``current()`` elsewhere, on
    this thread for the duration (None: no context). The context is
    thread-local, and autograd runs a card's backward, with the recompute
    of a checkpointed block, on a thread of its own: the recompute
    restores the forward's context so that it issues the same collectives."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def constrain(x, logical: tuple[Optional[str], ...]):
    """The identity: eager PyTorch has no sharding constraint to attach to
    an activation (the reference's ``with_sharding_constraint``), and every
    rank holds its activations whole."""
    return x


def named_sharding(logical: tuple[Optional[str], ...]) -> Optional[tuple]:
    """The spec of ``logical`` under the current context (None without)."""
    ctx = current()
    if ctx is None:
        return None
    return ctx.spec(logical)


# ---------------------------------------------------------------------------
# Parameter specs by path pattern
# ---------------------------------------------------------------------------

# (regex on '/'-joined path, logical axes per dim). First match wins.
# Stacked (layer-axis) params get a leading None for the layer dim.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"moe/(wi|wg)$", ("experts", "embed_w", "expert_ffn_w")),
    (r"moe/wo$", ("experts", "expert_ffn_w", "embed_w")),
    (r"moe/dense/(wi|wg)$", ("embed_w", "ffn_w")),
    (r"moe/dense/wo$", ("ffn_w", "embed_w")),
    (r"emb_tables$", ("tables", "table_rows", None)),
    (r"embed/table$", ("vocab", None)),        # pool rows over model (paper)
    (r"lm_head$", ("embed_w", "vocab")),
    (r"(wq|wk|wv)$", ("embed_w", "heads_w")),
    (r"wo$", ("heads_w", "embed_w")),          # attention out / mlp out
    (r"(wi|wg)$", ("embed_w", "ffn_w")),
    (r"router$", ("embed_w", None)),
    (r"in_proj$", ("embed_w", "ffn_w")),
    (r"out_proj$", ("ffn_w", "embed_w")),
    (r"bc_proj$", ("ffn_w", None)),
    (r"dt_proj$", ("ffn_w", None)),
    (r".*", None),                              # biases, norms: replicated
]

# logical weight-axis -> rules key (weights may shard differently from acts)
_WEIGHT_LOGICAL = {
    "embed_w": "w_embed", "heads_w": "w_heads", "ffn_w": "w_ffn",
    "expert_ffn_w": "w_expert_ffn",
}

DEFAULT_WEIGHT_RULES = {
    "w_embed": None,          # fsdp profile: "data"
    "w_heads": "model",
    "w_ffn": "model",
    "w_expert_ffn": None,     # fsdp profile for MoE: "data"
    "vocab": "model",
    "experts": "model",
    "tables": None,
    "table_rows": "model",
}

# the leaves held sharded under every context: those the islands read
# (the experts over ``experts``, and under a ``w_embed`` rule their embed
# dimension over its axis too)
EXPERT_LEAVES = r"moe/(wi|wg|wo)$"
ISLAND_LEAVES = (r"embed/table$", r"emb_tables$", EXPERT_LEAVES)
# the decoders' leaves held by their spec under a ``heads`` rule (dense
# tensor parallelism) or a ``w_embed`` rule (FSDP): the same leaves under
# either; the norms, mamba's conv and per-head leaves are held whole under
# both
TP_LEAVES = (r"attn/(wq|wk|wv|wo)$", r"mlp/(wi|wg|wo)$", r"moe/dense/(wi|wg|wo)$",
             r"moe/router$", r"mamba/(in_proj|out_proj|bc_proj|dt_proj)$", r"lm_head$")


def tp_axis(rules: dict[str, Any] | None, mesh_axes) -> Optional[str]:
    """The mesh axis that the ``heads`` rule of ``rules`` names, if it is
    one axis of the mesh; else None."""
    ax = _in_mesh((rules or {}).get("heads"), set(mesh_axes))
    if isinstance(ax, tuple):
        raise NotImplementedError(f"a heads rule over several axes {ax}: dense "
                                  "tensor parallelism runs over one mesh axis")
    return ax


def fsdp_axis(rules: dict[str, Any] | None, mesh_axes) -> Optional[str]:
    """The mesh axis that the ``w_embed`` weight rule of ``rules`` names
    (FSDP), if it is one axis of the mesh; else None."""
    ax = _in_mesh((rules or {}).get("w_embed"), set(mesh_axes))
    if isinstance(ax, tuple):
        raise NotImplementedError(f"a w_embed rule over several axes {ax}: FSDP "
                                  "runs over one mesh axis")
    return ax


def is_tp_leaf(path: str) -> bool:
    """Whether the leaf at ``path`` is one of the decoders' projections,
    the router or the head (``TP_LEAVES``), which a rank holds by its spec
    under a ``heads`` or a ``w_embed`` rule."""
    return any(re.search(p, path) for p in TP_LEAVES)


def is_expert_leaf(path: str) -> bool:
    """Whether ``path`` is an expert stack (``EXPERT_LEAVES``)."""
    return re.search(EXPERT_LEAVES, path) is not None


def is_island_leaf(path: str) -> bool:
    """Whether the leaf at ``path`` is held by its spec under every context
    (``ISLAND_LEAVES``: the tables and the experts)."""
    return any(re.search(p, path) for p in ISLAND_LEAVES)


def blocks_dense(rules: dict[str, Any] | None, mesh_axes) -> bool:
    """Whether ``rules`` hold the decoders' leaves by their spec: they
    name ``heads`` or ``w_embed`` (an axis of the mesh)."""
    return tp_axis(rules, mesh_axes) is not None or fsdp_axis(rules, mesh_axes) is not None


def spec_for(path: str, ndim: int, rules: dict[str, Any] | None = None,
             mesh_axes: set[str] | None = None) -> tuple:
    """The spec of the leaf at ``path`` ('/'-joined keys) with ``ndim``
    dims, by ``_PARAM_RULES`` (``param_specs`` for one leaf)."""
    r = dict(DEFAULT_WEIGHT_RULES)
    r.update(rules or {})

    def resolve(name):
        ax = r.get(_WEIGHT_LOGICAL.get(name, name))
        return ax if mesh_axes is None else _in_mesh(ax, mesh_axes)

    for pat, logical in _PARAM_RULES:
        if re.search(pat, path):
            if logical is None:
                return ()
            axes = [resolve(n) if n else None for n in logical]
            if ndim == len(axes) + 1:      # stacked (layer-axis) leaf
                axes = [None] + axes
            elif ndim != len(axes):
                return ()
            return tuple(axes[:ndim])
    return ()


def param_specs(params, rules: dict[str, Any] | None = None,
                mesh_axes: set[str] | None = None):
    """Spec tree for a params tree, by path-pattern rules."""
    return tree_map_with_path(
        lambda path, leaf: spec_for(path, leaf.ndim, rules, mesh_axes), params)


def _divisible(shape, spec, sizes) -> tuple:
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec)),
                       strict=False):
        if ax is None:
            out.append(None)
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= sizes[a]
        out.append(ax if dim % n == 0 else None)
    return tuple(out)


def check_divisibility(params, specs, mesh):
    """Downgrade spec axes whose size doesn't divide the dim (e.g. kv=1 GQA)."""
    return tree_map_with_path(
        lambda _, leaf, spec: _divisible(tuple(leaf.shape), spec, mesh.sizes),
        params, specs)


_KV_LEAVES = re.compile(r"attn/(wk|wv)$")


def held_spec(path: str, shape, mesh, rules: dict[str, Any] | None = None) -> tuple:
    """The spec by which a rank holds the leaf at ``path`` (``shape`` the
    whole leaf's): its ``param_specs`` entry, downgraded where the mesh does
    not divide it (``check_divisibility``), for the island leaves and, where
    ``rules`` name ``heads`` or ``w_embed``, for the dense projections and
    head (``TP_LEAVES``); replicated for every other leaf. Under a
    ``heads`` rule a TP leaf's heads, ffn or vocab dimension must split
    over the TP axis (raises: the layers take every rank's block of them
    to be the same size), but ``wk``/``wv``'s, whose kv heads a rank may
    hold whole (``tensor_parallel.kv_replicated``)."""
    axes = set(mesh.axis_names)
    if is_tp_leaf(path) and blocks_dense(rules, axes):
        spec = spec_for(path, len(shape), rules, axes)
        held = _divisible(tuple(shape), spec, mesh.sizes)
        tp = tp_axis(rules, axes)
        if tp is not None and not _KV_LEAVES.search(path) and any(
                a == tp and h != tp for a, h in zip(spec, held, strict=True)):
            raise ValueError(f"dense tensor parallelism: {path} {tuple(shape)} does "
                             f"not split by {spec} over {mesh.sizes}")
        return held
    if not is_island_leaf(path):
        return ()
    spec = spec_for(path, len(shape), rules, axes)
    return _divisible(tuple(shape), spec, mesh.sizes)


def local_slices(shape, spec, mesh) -> tuple:
    """This rank's part of a leaf of ``shape`` held by ``spec``: one slice a
    dim, block i of n along a dim sharded over n ranks (i the rank's
    linear index over the dim's axes)."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec)),
                       strict=False):
        n = mesh.axis_size(ax)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {n} ranks ({ax})")
        i, step = mesh.axis_index(ax) if ax is not None else 0, dim // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def local_shard(leaf, spec, mesh):
    """A rank's part of ``leaf`` by ``spec``, a tensor of its own (the
    whole leaf itself where the spec shards nothing)."""
    if all(ax is None for ax in spec):
        return leaf
    return leaf[local_slices(leaf.shape, spec, mesh)].clone()


def shard_params(params, mesh, rules: dict[str, Any] | None = None):
    """The tree a rank holds: each leaf cut by ``held_spec``."""
    return tree_map_with_path(
        lambda path, leaf: local_shard(leaf, held_spec(path, leaf.shape, mesh, rules),
                                       mesh), params)


def keep_shard(mesh, rules: dict[str, Any] | None = None):
    """``keep(path, leaf)`` for the inits (``init_lm``, ``init_dlrm``): a
    leaf drawn whole comes back as this rank's part of it, so that the
    init holds one whole leaf at a time and never the whole model."""
    def keep(path, leaf):
        return local_shard(leaf, held_spec(path, leaf.shape, mesh, rules), mesh)
    return keep


def shard_batch(batch: dict, mesh, rules: dict[str, Any] | None = None) -> dict:
    """This rank's part of a global batch: the slice of each entry's leading
    dimension (``positions3``: dimension 1) that the reference's
    ``batch_shardings`` puts on this rank's device, block i of n over the
    data-parallel axes (i the rank's linear index over them). Every rank
    draws the global batch from one seed, so the parts are disjoint and
    tile it. Raises where a batch dimension does not split over the axes."""
    ax = _in_mesh({**DEFAULT_RULES, **(rules or {})}.get("batch"), set(mesh.axis_names))
    n = mesh.axis_size(ax)
    if n == 1:
        return batch
    i = mesh.axis_index(ax)
    out = {}
    for key, v in batch.items():
        dim = 1 if key == "positions3" else 0
        if v.shape[dim] % n:
            raise ValueError(f"shard_batch: {key} {tuple(v.shape)} does not split "
                             f"over {n} ranks ({ax}) on dimension {dim}")
        step = v.shape[dim] // n
        out[key] = v.narrow(dim, i * step, step).contiguous()
    return out
