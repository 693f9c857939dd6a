"""Pytrees as ``jax.tree`` sees them, for the optimizers and checkpoints.

Nodes are dicts (children in sorted key order), NamedTuples (field order),
tuples and lists (their order); ``None`` is a node with no children;
everything else is a leaf.  This is ``jax.tree_util``'s order, so a
checkpoint's leaf list means the same tree in both packages.
"""
from __future__ import annotations

from typing import Any, Callable


class TreeDef:
    """The structure of a flattened tree: a node's kind and its children."""

    __slots__ = ("kind", "meta", "children")

    def __init__(self, kind: str, meta: Any = None, children: tuple = ()):
        self.kind, self.meta, self.children = kind, meta, children

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.meta == other.meta
                and self.children == other.children)

    def __repr__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(map(repr, self.children))
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c!r}" for k, c in
                                   zip(self.meta, self.children)) + "}"
        if self.kind == "namedtuple":
            return f"{self.meta.__name__}({inner})"
        return f"[{inner}]" if self.kind == "list" else f"({inner})"


_LEAF = TreeDef("leaf")


def flatten(tree) -> tuple[list, TreeDef]:
    """(leaves, treedef), the leaves in ``jax.tree.flatten``'s order."""
    leaves: list = []

    def go(t) -> TreeDef:
        if t is None:
            return TreeDef("none")
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return TreeDef("dict", keys, tuple(go(t[k]) for k in keys))
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return TreeDef("namedtuple", type(t), tuple(go(c) for c in t))
        if isinstance(t, (tuple, list)):
            return TreeDef(type(t).__name__, None, tuple(go(c) for c in t))
        leaves.append(t)
        return _LEAF

    return leaves, go(tree)


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` in flatten's order."""
    it = iter(leaves)

    def go(d: TreeDef):
        if d.kind == "leaf":
            return next(it)
        if d.kind == "none":
            return None
        kids = [go(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.meta, kids))
        if d.kind == "namedtuple":
            return d.meta(*kids)
        return list(kids) if d.kind == "list" else tuple(kids)

    out = go(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree of ``rest`` (all
    of one structure), rebuilt as ``tree``."""
    flat, td = flatten(tree)
    others = []
    for r in rest:
        fl, d = flatten(r)
        if d != td:
            raise ValueError(f"tree_map: structures differ: {td} vs {d}")
        others.append(fl)
    return unflatten(td, [fn(*xs) for xs in zip(flat, *others)])
