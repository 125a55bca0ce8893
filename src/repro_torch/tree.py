"""Nested dict/list parameter trees (the JAX package's pytree layout).

Dict keys are visited in sorted order, as ``jax.tree.leaves`` visits them,
so sums over leaves run in the reference's order.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs)
                          for xs in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *others)`` over ``tree``'s leaves, ``path`` the
    '/'-joined dict keys and list indices down to the leaf (the reference's
    ``tree_flatten_with_path`` names). The ``rest`` trees are walked along
    ``tree``'s structure, so their entries at its leaves may be anything
    (a spec tuple, say)."""
    def down(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest), path=down(k))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, *(r[i] for r in rest), path=down(i))
                          for i, t in enumerate(tree))
    return fn(path, tree, *rest)
