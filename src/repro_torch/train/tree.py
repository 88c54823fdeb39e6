"""Nested containers of tensors ("trees"), as the JAX package's pytrees.

A tree is a dict (children in sorted key order, as ``jax.tree`` orders
them), a list or tuple, a dataclass (its fields in declaration order, as
``jax.tree_util.register_dataclass`` does, e.g. ``VocabState``), ``None``
(no leaves), or a leaf: anything else, a tensor or an array. The
parameter, optimizer-state and checkpoint trees of ``train/`` use them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator


def _children(node) -> list[tuple[str, Any]] | None:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def leaves_with_paths(tree, prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    """Every leaf with its path of keys, indices and field names."""
    if tree is None:
        return
    children = _children(tree)
    if children is None:
        yield prefix, tree
        return
    for name, child in children:
        yield from leaves_with_paths(child, prefix + (name,))


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` in :func:`leaves` order, with the
    subtrees of ``rest`` at the same places (a whole subtree where ``tree``
    has a leaf, as ``flatten_up_to``), in a tree of ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: tuple[str, ...] = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, each with its path
    as :func:`leaves_with_paths` gives it, in a tree of ``tree``'s
    structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], prefix + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name), prefix + (f.name,))
            for f in dataclasses.fields(tree)
        })
    return fn(prefix, tree)
