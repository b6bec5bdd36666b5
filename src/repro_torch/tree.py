"""Nested dict / list / tuple trees of tensors: the parameter, gradient
and optimizer-state trees (the port's counterpart of ``jax.tree_util``
for them).  Dict keys are visited in sorted order, as JAX's flatten
does, so two trees of one structure give their leaves in one order."""
from __future__ import annotations

from typing import Any, Callable


def _children(node: Any) -> list[tuple[Any, Any]] | None:
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def with_paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in flatten order; a path holds the dict keys and
    sequence indices on the way to the leaf."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(with_paths(child, prefix + (key,)))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in with_paths(tree)]


def unflatten(like: Any, flat: list) -> Any:
    """A tree of ``like``'s structure holding ``flat`` in flatten order."""
    it = iter(flat)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(v) for v in node)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a tree of the same structure."""
    others = [leaves(r) for r in rest]
    flat = leaves(tree)
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*args) for args in zip(flat, *others)])
