"""Nested dicts (and tuples) of tensors: the port's pytrees.

Parameters, gradients and optimizer states are plain nested dicts, as in
the reference.  These helpers walk them in ``jax.tree_util``'s order (dict
keys sorted, tuples and lists by index), so a sum over leaves adds in the
reference's order and a leaf's path names it as the reference's
``tree_flatten_with_path`` does.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(tree) -> list[tuple[Any, Any]] | None:
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def flatten_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` with ``path`` the tuple of keys / indices
    from the root."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for k, sub in kids
            for item in flatten_with_path(sub, prefix + (k,))]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template, values) -> Any:
    """``template``'s nesting with its leaves replaced, in
    :func:`leaves` order, by ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the template's own key order
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def map(fn: Callable, tree, *rest):  # noqa: A001 - jax.tree.map's name
    """``fn`` applied leafwise over ``tree`` and trees of its nesting."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
