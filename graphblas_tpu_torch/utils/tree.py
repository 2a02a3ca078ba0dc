"""Tree helpers over nested dicts: the value form of user-defined types.

A user-defined (struct) type's values are a struct-of-arrays: a dict
that maps each field name to a tensor, or to a nested dict for a nested
struct (``graphblas_tpu/core/types.py``, where the JAX package carries
them as pytrees).  These helpers map and flatten such trees; anything
that is not a dict is a leaf, so a builtin value (one tensor) is a tree
of one leaf and the same code serves both.

Leaves come in the order of the sorted keys, as ``jax.tree_util``
orders a dict: the JAX package sorts the value leaves of a user-defined
product as extra sort operands, and a port that flattens in another
order would pair its leaves differently.  ``torch.utils._pytree`` is
not used: it is private, and it keeps a dict's insertion order.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_flatten", "tree_unflatten",
           "is_tree"]


def is_tree(x) -> bool:
    """Whether ``x`` is a struct value (a dict), not a single leaf."""
    return isinstance(x, dict)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        out: List[Any] = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


def _structure(tree):
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    return None


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves in sorted-key order, the tree's structure)."""
    return tree_leaves(tree), _structure(tree)


def tree_unflatten(structure, leaves):
    """The tree of ``structure`` holding ``leaves`` (in the order
    :func:`tree_flatten` gives them)."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        return {k: build(sub) for k, sub in s}
    out = build(structure)
    return out
