"""Nested-dict trees: the port's stand-in for JAX pytrees of tensors.

Leaves are visited in sorted key order at every level, the order in which
``jax.tree_util`` flattens a dict, so a reduction over a tree sums its
leaves in the JAX package's order.
"""
from __future__ import annotations


def tree_leaves(tree) -> list:
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of the results."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
