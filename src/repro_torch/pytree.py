"""Nested parameter and cache trees: the port's stand-in for JAX pytrees.

A tree is a ``dict`` or a ``list`` of trees, or a leaf (anything else:
a tensor, a ``models.layers.PV``, a logical-axes tuple).  Leaves are
listed with dict keys in sorted order, the order in which JAX flattens a
dict, so ``tree_leaves`` of a port tree lines up with ``jax.tree.leaves``
of the reference's tree of the same structure.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf; ``rest`` are trees of the same
    structure whose leaves at the same place are passed along."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path: Tuple = ()
                          ) -> Iterator[Tuple[Tuple, Any]]:
    """(path of keys and indices, leaf) pairs, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
