"""Nested dicts, lists and tuples of tensors ("trees"), walked in the order
JAX's ``tree_util`` walks them: a dict by its sorted keys, a list or tuple
by position, ``None`` holding no leaf. The optimizer state and the
checkpoint format depend on that order, so the port keeps it."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_path(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)]: path is the tuple of dict keys and sequence indices
    leading to the leaf."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in flatten_with_path(tree[key], prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in flatten_with_path(sub, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: Any, values: List[Any]) -> Any:
    """A tree of ``like``'s structure whose leaves are ``values``, in
    ``leaves(like)`` order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            out = {key: None for key in node}     # keep the caller's key order
            for key in sorted(node):
                out[key] = build(node[key])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return None if node is None else next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of ``rest``, trees of the same
    structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree),
                                                  *map(leaves, rest))])
