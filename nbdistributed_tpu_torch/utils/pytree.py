"""Pytrees of nested containers, flattened in the JAX package's order.

``jax.tree_util`` flattens a dict by its sorted keys, a list or a tuple
in order, and takes ``None`` for an empty subtree; every other value is
a leaf.  The port keeps that order, so that leaf ``i`` of a tree is the
same leaf in both packages (checkpoint manifests, fingerprints and the
chaos plan's leaf names agree), and describes the structure in
builtins only, so that a pickled description needs nothing of either
package to load.

A ``torch.optim.Optimizer`` is a node here: it flattens as its
``state_dict()`` (the counterpart of an optax state pytree), and
unflattens to that state dict.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["tree_flatten", "tree_leaves", "tree_leaves_with_path",
           "tree_unflatten"]


def _children(value):
    """``(kind, keys, children)`` of a node, or None for a leaf.  Exact
    container types only: a subclass (a NamedTuple, an OrderedDict)
    stays a leaf rather than coming back as its base type."""
    t = type(value)
    if value is None:
        return "none", (), ()
    if t is dict:
        keys = tuple(sorted(value))
        return "dict", keys, tuple(value[k] for k in keys)
    if t is list or t is tuple:
        return t.__name__, tuple(range(len(value))), tuple(value)
    if isinstance(value, torch.optim.Optimizer):
        return "optimizer", ("state_dict",), (value.state_dict(),)
    return None


def _flatten(value, path, leaves, paths):
    node = _children(value)
    if node is None:
        leaves.append(value)
        paths.append(path)
        return ("leaf",)
    kind, keys, kids = node
    specs = tuple(_flatten(v, path if kind == "optimizer" else path + (k,),
                           leaves, paths) for k, v in zip(keys, kids))
    if kind == "dict":
        return ("dict", keys, specs)
    if kind == "optimizer":
        return ("optimizer", type(value).__name__, specs[0])
    if kind == "none":
        return ("none",)
    return (kind, specs)


def tree_flatten(value) -> tuple[list, tuple]:
    """``(leaves, spec)``: the leaves in JAX's order, and a description
    of the structure made of tuples, strings and the dict keys."""
    leaves: list = []
    spec = _flatten(value, (), leaves, [])
    return leaves, spec


def tree_leaves(value) -> list:
    return tree_flatten(value)[0]


def _keystr(path) -> str:
    """``jax.tree_util.keystr``: ``['layers']['wq']``, ``[0]``."""
    return "".join(f"[{k!r}]" for k in path)


def tree_leaves_with_path(value) -> list[tuple[str, Any]]:
    """``(keystr, leaf)`` per leaf, named as ``jax.tree_util.keystr``
    names them (``"['layers']['wq']"``)."""
    leaves: list = []
    paths: list = []
    _flatten(value, (), leaves, paths)
    return [(_keystr(p), leaf) for p, leaf in zip(paths, leaves)]


def tree_unflatten(spec: tuple, leaves) -> Any:
    """The tree ``spec`` describes, with ``leaves`` in order (an
    optimizer node comes back as its state dict)."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        if kind == "optimizer":
            return build(s[2])
        items = [build(c) for c in s[1]]
        return items if kind == "list" else tuple(items)

    out = build(spec)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree spec holds")
    return out


_END = object()
