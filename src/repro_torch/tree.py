"""Minimal pytree helpers over nested dicts / lists / tuples of tensors.

Leaf order follows ``jax.tree_util``: dict keys sorted, sequences in order,
so per-leaf sums (the sync's S_k) run in the reference's order.  An empty
dict (OLMo's non-parametric norms) is a node with no leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List

Pytree = Any


def tree_leaves(tree: Pytree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """``fn`` over matching leaves of ``tree`` and ``rest`` (same
    structure), visited in ``tree_leaves`` order; containers are rebuilt,
    so the result shares no node."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(like: Pytree, leaves: List[Any]) -> Pytree:
    """The structure of ``like`` filled with ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
