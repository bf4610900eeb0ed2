"""Nested dicts and lists of tensors (the port's parameter and state
trees), walked the way ``jax.tree`` walks the JAX package's: dict keys in
sorted order, list items in order, anything else (a tuple too) a leaf."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching nodes of
    ``rest``. ``tree``'s structure is a prefix of each of ``rest``'s: where
    ``tree`` has a leaf, ``fn`` gets the whole node of the others (as
    ``jax.tree.map`` passes a subtree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, x, *(r[i] for r in rest))
                for i, x in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, paths as in
    ``tree_leaves_with_path``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, x, prefix + (i,))
                for i, x in enumerate(tree)]
    return fn(prefix, tree)


def tree_leaves_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]``: a path is the dict keys and list indices
    from the root."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [item for i, x in enumerate(tree)
                for item in tree_leaves_with_path(x, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def unzip(tree, n: int) -> tuple:
    """A tree whose leaves are ``n``-tuples as ``n`` trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))
