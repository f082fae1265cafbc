"""Flatten and rebuild nested training state in jax's leaf order.

The reference's optimizer and checkpointer walk their trees with
``jax.tree``; the port keeps the same order so a checkpoint's
``leaf_i`` means the same leaf in both packages:

* a dict contributes its values in sorted-key order;
* a list, a tuple and a NamedTuple their items in order;
* None and an empty container contribute no leaf (the ``{}`` that
  ``bn_state`` holds for a layer without batch norm);
* anything else (a tensor, an array, a Python scalar or bool) is one
  leaf.

A :class:`TreeDef` records the containers, so ``unflatten(treedef,
leaves)`` rebuilds the same nesting around new leaves.
``flatten_with_path`` names each leaf as the reference's sharding rules
do (``runtime.sharding``); ``is_leaf`` stops the walk at a container
(a ``PartitionSpec`` is a tuple).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["TreeDef", "flatten", "flatten_with_path", "leaves", "map",
           "unflatten"]

IsLeaf = Optional[Callable[[Any], bool]]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


class TreeDef:
    """The containers of a tree with its leaves taken out.

    ``kind`` is "leaf", "none", "dict", "list", "tuple" or
    "namedtuple"; ``meta`` the sorted keys of a dict or the class of a
    NamedTuple; ``children`` the TreeDefs of the items."""
    __slots__ = ("kind", "meta", "children", "n_leaves")

    def __init__(self, kind: str, meta: Any = None,
                 children: Tuple["TreeDef", ...] = ()):
        self.kind = kind
        self.meta = meta
        self.children = children
        self.n_leaves = 1 if kind == "leaf" else \
            sum(c.n_leaves for c in children)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, TreeDef) and \
            (self.kind, self.meta, self.children) == \
            (other.kind, other.meta, other.children)

    def __repr__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(repr(c) for c in self.children)
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c!r}" for k, c in
                                   zip(self.meta, self.children)) + "}"
        if self.kind == "list":
            return f"[{inner}]"
        if self.kind == "namedtuple":
            return f"{self.meta.__name__}({inner})"
        return f"({inner}{',' if len(self.children) == 1 else ''})"


def _flatten(tree: Any, out: List[Any], is_leaf: IsLeaf = None,
             paths: Optional[List[str]] = None, path: str = "") -> TreeDef:
    """Append ``tree``'s leaves to ``out`` (and, when ``paths`` is a
    list, each leaf's path to it)."""
    def sub(v: Any, key: Any) -> TreeDef:
        if paths is None:
            return _flatten(v, out, is_leaf)
        return _flatten(v, out, is_leaf, paths,
                        f"{path}/{key}" if path else str(key))

    if tree is None:
        return TreeDef("none")
    if is_leaf is None or not is_leaf(tree):
        if isinstance(tree, dict):
            keys = tuple(sorted(tree))
            return TreeDef("dict", keys, tuple(sub(tree[k], k) for k in keys))
        if _is_namedtuple(tree):
            return TreeDef("namedtuple", type(tree),
                           tuple(sub(v, f) for f, v in
                                 zip(tree._fields, tree)))
        if isinstance(tree, (list, tuple)):
            return TreeDef("list" if isinstance(tree, list) else "tuple",
                           None, tuple(sub(v, i) for i, v in enumerate(tree)))
    out.append(tree)
    if paths is not None:
        # the reference flattens a PackedArray to its words leaf (matched
        # by name: kernels.packed imports this module)
        words = type(tree).__name__ == "PackedArray"
        paths.append(f"{path}/words" if words and path else
                     "words" if words else path)
    return TreeDef("leaf")


def flatten(tree: Any, is_leaf: IsLeaf = None) -> Tuple[List[Any], TreeDef]:
    """(leaves in jax's order, the tree's structure)."""
    out: List[Any] = []
    treedef = _flatten(tree, out, is_leaf)
    return out, treedef


def flatten_with_path(tree: Any, is_leaf: IsLeaf = None
                      ) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """([(path, leaf)] in jax's order, the tree's structure).  A path
    joins with "/" what the reference's ``sharding._key_str`` gives for
    each key: a dict key, a sequence index, a NamedTuple field name, and
    ``words`` for a PackedArray (one leaf here, its words leaf there)."""
    out: List[Any] = []
    paths: List[str] = []
    treedef = _flatten(tree, out, is_leaf, paths)
    return list(zip(paths, out)), treedef


def leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    return flatten(tree, is_leaf)[0]


def unflatten(treedef: TreeDef, flat: List[Any]) -> Any:
    """Rebuild ``treedef``'s containers around ``flat`` (as many leaves
    as it holds)."""
    if len(flat) != treedef.n_leaves:
        raise ValueError(f"{treedef.n_leaves} leaves expected, got "
                         f"{len(flat)}")
    it = iter(flat)

    def build(td: TreeDef) -> Any:
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        items = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.meta, items))
        if td.kind == "namedtuple":
            return td.meta(*items)
        return items if td.kind == "list" else tuple(items)

    return build(treedef)


def map(fn: Callable[..., Any], tree: Any, *rest: Any,
        is_leaf: IsLeaf = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    every tree in ``rest`` (each of the same structure)."""
    flat, treedef = flatten(tree, is_leaf)
    others = []
    for r in rest:
        f, td = flatten(r, is_leaf)
        if td != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {td}")
        others.append(f)
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
