"""Nested dicts of tensors as trees (the port's stand-in for `jax.tree`):
parameters, gradients and optimizer moments share one dict layout."""
from __future__ import annotations


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts of one structure, in the first
    tree's key order."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in `tree_map`'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of `like`'s structure holding `leaves` (tree_leaves order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
