"""Nested dict/list trees of tensors: the port's stand-in for JAX pytrees.

Parameters, gradients and optimizer slots are plain nested dicts and lists
with tensors at the leaves (the reference's leaf paths). ``tree_map`` walks
several trees of one structure together; ``leaves`` lists (path, leaf)
pairs and ``tree_leaves`` the leaves alone, both with dict keys sorted and
list entries in order (JAX's flattening order; a NamedTuple's fields in
order). ``unflatten`` puts leaves back into a tree's structure, and
``treedef_str`` writes that structure as JAX's ``str(treedef)`` does, the
form the checkpoint index and the registry fingerprint record.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of the same
    structure; dicts stay dicts, lists and tuples become lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs in a fixed order: dict keys sorted, list entries
    in order; paths read like ``image/tower/blocks/0/attn/wq``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def unflatten(like, new_leaves: Iterable):
    """The structure of ``like`` with its leaves replaced, one by one in the
    order of ``leaves``, by those of ``new_leaves``: dicts come back with
    sorted keys, lists as lists, tuples and NamedTuples as their own
    type."""
    it = iter(new_leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(rebuild(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)
    return rebuild(like)


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(_structure(v) for v in tree) + "])")
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def treedef_str(tree) -> str:
    """The structure of ``tree`` as JAX 0.9's ``str(treedef)`` writes it:
    ``PyTreeDef({'a': *, 'b': [*, (*,)]})`` with dict keys sorted, ``*``
    for a leaf, ``None`` for an empty subtree and
    ``CustomNode(namedtuple[Name], [...])`` for a NamedTuple."""
    return f"PyTreeDef({_structure(tree)})"


def tree_leaves(tree) -> List:
    """The leaves of ``tree``, in the order of ``leaves``."""
    return [x for _, x in leaves(tree)]
