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


def tree_leaves_with_path(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` in :func:`tree_leaves` order; ``path`` is the
    string ``jax.tree_util.keystr`` gives the same leaf of the same tree
    (``"['params']['embed']"``; ``""`` for a lone leaf)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pair for k in sorted(tree)
            for pair in tree_leaves_with_path(tree[k], f"{prefix}[{k!r}]")]


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, paths as in
    :func:`tree_leaves_with_path`; returns a tree of the results."""
    if not isinstance(tree, dict):
        return fn(prefix, tree)
    return {k: tree_map_with_path(fn, tree[k], f"{prefix}[{k!r}]")
            for k in tree}


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of the results."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
