"""Nested-dict parameter trees, walked in the order ``jax.tree`` walks them.

The port's params, optimizer state, grads and masks are nested dicts laid
out like the reference pytrees.  ``jax.tree.flatten`` visits dict keys in
sorted order and treats ``None`` as an empty subtree; these helpers do the
same, so a per-leaf sequence (a noise draw per leaf, a checkpoint key)
lines up with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

__all__ = ["leaves_with_paths", "leaves", "map_with_path"]

Path = Tuple[str, ...]


def leaves_with_paths(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(key path, leaf) of every leaf, dict keys sorted, ``None`` skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    elif tree is not None:
        yield path, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_with_path(fn: Callable[[Path, Any], Any], tree: Any, path: Path = ()) -> Any:
    """The same nesting with ``fn(path, leaf)`` at each leaf; ``None`` stays."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return None if tree is None else fn(path, tree)
