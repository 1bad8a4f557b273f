"""The few tree operations the port needs on its parameter, optimizer and
cache trees: nested dicts, lists and tuples whose other nodes are leaves
(``jax.tree``'s role in the reference).  Leaves come in insertion order,
depth first.  Pure Python."""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _walk(tree: Any, path: str) -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in _walk(tree, "")]


def tree_paths(tree: Any) -> list[str]:
    """Each leaf's key path (``/stacks/s0/1/b0/attn/wq``), in leaf order."""
    return [path for path, _ in _walk(tree, "")]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), in a tree of the same structure.
    ``is_leaf(node)`` of each node of the last tree in ``rest``, where
    given, stops the walk there (a leaf that is itself a list)."""
    if is_leaf is not None and rest and is_leaf(rest[-1]):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out
