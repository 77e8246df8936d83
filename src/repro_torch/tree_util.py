"""Trees of tensors in jax.tree_util's leaf order.

    leaves, treedef = tree_flatten(params)     # leaves in jax's order
    params2 = tree_unflatten(treedef, leaves)
    summed = tree_map(torch.add, a, b)

Leaf order is jax.tree_util's, not torch's: dicts flatten in SORTED key
order, NamedTuples (and tuples/lists) in field order, and None fields are
dropped. Every place where the port walks a model tree in order (packing,
one key per leaf, a sum over leaves) goes through here, so it walks the
tree as the reference does: a different order would shuffle the layout
or the keys without failing anywhere.

The walks are module-level functions, not nested closures that call
themselves: such a closure is a reference cycle, and one that holds the
leaf list keeps every tensor of the tree alive until Python's cycle
collector runs (on the card, gigabytes of a round's transients).
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

_LEAF = "*"


def _flatten_into(x, leaves: List[torch.Tensor]):
    if x is None:
        return None
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_flatten_into(x[k], leaves) for k in keys))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ("namedtuple", type(x), tuple(_flatten_into(v, leaves) for v in x))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, None, tuple(_flatten_into(v, leaves) for v in x))
    leaves.append(x)
    return _LEAF


def _unflatten_from(node, it):
    if node is None:
        return None
    if node == _LEAF:
        return next(it)
    kind, aux, children = node
    built = [_unflatten_from(c, it) for c in children]
    if kind == "dict":
        return dict(zip(aux, built))
    if kind == "namedtuple":
        return aux(*built)
    return tuple(built) if kind == "tuple" else list(built)


def tree_flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """(leaves, treedef) in jax.tree_util's order; treedef is hashable."""
    leaves: List[torch.Tensor] = []
    return leaves, _flatten_into(tree, leaves)


def tree_unflatten(treedef, leaves) -> Any:
    return _unflatten_from(treedef, iter(leaves))


def tree_map(fn, tree, *rest) -> Any:
    """jax.tree_util.tree_map over the port's trees: `fn` on the leaves of
    `tree` and of each tree in `rest` (which must share its structure), in
    jax's leaf order."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_def = tree_flatten(other)
        if o_def != treedef:
            raise ValueError("tree_map: tree structures differ")
        others.append(o_leaves)
    return tree_unflatten(treedef, [fn(*args) for args in zip(leaves, *others)])
