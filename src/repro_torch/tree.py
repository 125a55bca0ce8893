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
