"""Parameter-tree helpers: the port's copy of what it needs of the JAX
package's ``repro.common.tree`` and of JAX's tree flattening.

A tree is nested dicts, tuples (NamedTuples among them) and lists with
tensors (or arrays) at the leaves.  Leaves come in JAX's order: a dict's
entries by **sorted** key, a tuple's and a list's by position.  A leaf's
name joins its path with ``'/'``: a dict key, a NamedTuple's field name,
a tuple's or list's index — ``0/emb``, ``1/mu/layers/attn/wq/w``,
``1/step`` for a (params, AdamWState) pair, the keys of a checkpoint.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    return []


def _is_leaf(node) -> bool:
    return not isinstance(node, (dict, tuple, list))


def named_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path name, leaf)] in JAX's leaf order."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out += named_leaves(child, f"{prefix}/{name}" if prefix else name)
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure), in a tree of the same structure."""
    return tree_map_with_path_names(lambda _, *xs: fn(*xs), tree, *rest)


def tree_map_with_path_names(fn: Callable, tree: Any, *rest: Any, prefix: str = "") -> Any:
    """``tree_map`` where ``fn`` also receives the leaf's '/'-joined name
    first (``repro.common.tree.tree_map_with_path_names``)."""
    if _is_leaf(tree):
        return fn(prefix, tree, *rest)

    def sub(name, *nodes):
        return tree_map_with_path_names(fn, *nodes, prefix=f"{prefix}/{name}" if prefix else name)

    if isinstance(tree, dict):
        return {k: sub(str(k), tree[k], *(r[k] for r in rest)) for k in tree}
    kids = [sub(name if hasattr(tree, "_fields") else str(i), c, *(r[i] for r in rest))
            for i, (name, c) in enumerate(_children(tree))]
    if hasattr(tree, "_fields"):
        return type(tree)(*kids)
    return type(tree)(kids)
