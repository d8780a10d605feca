"""Parameter trees: nested dicts and lists of tensors.

The port keeps parameters as plain nested containers (``{"embed": {...},
"layers": [...], ...}``), the counterpart of the JAX package's pytrees.
These helpers flatten such a tree in a fixed order (dict keys sorted, list
order kept) and map a function over its leaves.
"""
from __future__ import annotations

from typing import Callable, List


def leaves(tree) -> List:
    """The tree's leaves, dict keys in sorted order, list order kept."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure); returns a tree of its results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(tree, flat):
    """A tree shaped like ``tree`` whose leaves are ``flat``, taken in the
    order of :func:`leaves`."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out
