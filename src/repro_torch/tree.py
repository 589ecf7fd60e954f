"""Nested dict/list trees of tensors: the port's stand-in for JAX pytrees.

Parameters, gradients and optimizer slots are plain nested dicts and lists
with tensors at the leaves (the reference's leaf paths). ``tree_map`` walks
several trees of one structure together; ``leaves`` lists (path, leaf)
pairs and ``tree_leaves`` the leaves alone, both with dict keys sorted and
list entries in order.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple


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


def tree_leaves(tree) -> List:
    """The leaves of ``tree``, in the order of ``leaves``."""
    return [x for _, x in leaves(tree)]
