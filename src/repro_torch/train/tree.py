"""Trees of the training path: nested dicts whose leaves are tensors
(or ``None`` for an absent subtree), walked in sorted key order, the
order ``jax.tree`` flattens a dict in.  A sum over leaves (the global
norm) therefore adds in the reference's order.
"""
from __future__ import annotations

from typing import Callable

__all__ = ["leaves", "map_trees", "pick"]


def leaves(tree) -> list:
    """The leaves of ``tree`` in sorted key order (``None`` has none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def map_trees(fn: Callable, tree, *rest):
    """``fn(leaf, *the same paths of rest)`` along ``tree``'s structure:
    only ``tree``'s dicts are descended into, so ``fn`` may return a tuple
    and a ``rest`` entry at a leaf's path may be a whole subtree (a
    parameter's Adafactor stats dict)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_trees(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def pick(tree, i: int):
    """The ``i``-th element of every tuple leaf of ``tree``."""
    return map_trees(lambda t: t[i], tree)
