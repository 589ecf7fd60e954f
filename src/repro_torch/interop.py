"""Parameters between the reference and the port.

The reference keeps its parameters as a pytree of nested dicts and lists;
the port keeps the same tree with the same leaf paths, including the
stacked ``blocks`` layout (one list entry per layer-period position, all
layers on a leading axis), so each leaf maps one to one and the conversion
is a copy. The reference's tree comes in as numpy arrays (its caller runs
``jax.device_get``); this module imports nothing of the reference.

``init_params`` draws a fresh dual encoder with the reference's init law
from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.models.dual_encoder import init_params  # noqa: F401


def from_numpy(tree, device=None):
    """Nested dicts/lists of numpy arrays (or scalars) -> the same tree of
    torch tensors on ``device``, dtypes kept."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree):
    """The inverse of ``from_numpy``: torch tensors -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def to_device(tree, device):
    """The same tree with every tensor on ``device`` (no copy where a
    tensor is there already)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


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
