"""Minimal pytree helpers for nested lists / tuples / dicts of tensors.

Leaf order follows ``jax.tree.flatten``: sequences in order, dict keys
SORTED. The model parameters are a list of ``{"w", "b"}`` dicts, so each
layer flattens as ``[b, w]``, and the fused (C, P) delta layout, the DP
noise vector and the segment ids all follow that order.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _build(t, it):
    if isinstance(t, dict):
        out = {}
        for k in sorted(t):
            out[k] = _build(t[k], it)
        return {k: out[k] for k in t}  # keep the caller's key order
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def unflatten(like, flat: list):
    """Rebuild a tree shaped like ``like`` from ``flat`` leaves. (A module
    function, not a recursive closure: a closure that calls itself is a
    reference cycle, and it would keep ``flat``, so every leaf, alive until
    the cyclic garbage collector ran.)"""
    return _build(like, iter(flat))


def map(fn: Callable[..., Any], tree, *rest):  # noqa: A001 - mirrors jax.tree.map
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
