"""Parameters between the reference and the port.

The reference keeps its parameters as a pytree of nested dicts and lists;
the port keeps the same tree with the same leaf paths, including the
stacked ``blocks`` layout (one list entry per layer-period position, its
layers on a leading axis; a MoE block's ``moe`` subtree with its expert
axis after the layer axis), so each leaf maps one to one and the
conversion is a copy. The reference's tree comes in as numpy arrays (its caller runs
``jax.device_get``); this module imports nothing of the reference.

``init_params`` draws a fresh dual encoder or LM with the reference's init
law from a ``torch.Generator``. An LM's parameters come over through
``from_numpy`` as they are; ``caches_from_numpy`` / ``caches_to_numpy``
carry decode caches (the list of stacked ``KVCache``s or ``SSMCache``s)
both ways, a hybrid model's list holding both kinds. ``cut_experts``
cuts a parameter tree to an expert share (``models.moe``).
``opt_state_from_numpy`` / ``opt_state_to_numpy``
carry an AdaFactorW state (the reference's ``AdaFactorWState`` as numpy
arrays) both ways, with the same rule: every conversion onto torch names
its device, there is no default.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.dual import DualEncoderConfig
from repro_torch.models import dual_encoder as de
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache
from repro_torch.optim.adafactorw import AdaFactorWState
from repro_torch.tree import leaves  # noqa: F401


def init_params(cfg, generator: torch.Generator, device,
                experts=None) -> dict:
    """Fresh parameters with the reference's init law: a
    ``DualEncoderConfig`` gets a dual encoder, an ``ArchConfig`` a tower
    or LM (with ``experts`` = (first, count), only that share of every MoE
    layer's experts); drawn from ``generator`` and put on ``device``
    (required)."""
    if isinstance(cfg, DualEncoderConfig):
        if experts is not None:
            raise ValueError("a dual encoder has no experts to share")
        return de.init_params(cfg, generator, device)
    if isinstance(cfg, ArchConfig):
        return tf.init_params(cfg, generator, device, experts)
    raise TypeError(f"no parameters for a {type(cfg).__name__}")


def _leaf_from_numpy(x, device) -> torch.Tensor:
    arr = np.array(x, copy=True)
    if arr.dtype.name == "bfloat16":
        # numpy has no bf16 of its own; the widening to f32 is exact
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(arr).to(device)


def from_numpy(tree, device):
    """Nested dicts/lists of numpy arrays (or scalars) -> the same tree of
    torch tensors on ``device`` (required: there is no default), dtypes
    kept, bfloat16 included."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy(v, device) for v in tree]
    return _leaf_from_numpy(tree, device)


def to_numpy(tree):
    """The inverse of ``from_numpy``: torch tensors -> numpy arrays (bf16
    leaves come back widened to float32, exactly)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def cut_experts(tree, experts):
    """The parameter tree of an LM, or a tree laid out as one (its
    gradients, an optimizer slot shaped like the params), the reference's
    as numpy or the port's, cut to the expert share ``experts`` = (first,
    count): ``wi``, ``wg`` and ``wo`` of every ``moe`` subtree sliced
    along the expert axis, the one after the layer axis; every other leaf
    as it is (not copied)."""
    first, count = (int(v) for v in experts)

    def cut(name, x):
        if x.shape[1] < first + count:
            raise ValueError(f"moe/{name} holds {x.shape[1]} experts, not "
                             f"{first} + {count}")
        return x[:, first:first + count]
    if isinstance(tree, dict):
        return {k: ({n: cut(n, x) if n in ("wi", "wg", "wo") else x
                     for n, x in v.items()} if k == "moe"
                    else cut_experts(v, experts))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cut_experts(v, experts) for v in tree]
    return tree


def opt_state_from_numpy(state, device) -> AdaFactorWState:
    """The reference's ``AdaFactorWState`` (step, m, v_row, v_col) as numpy
    -> the port's, on ``device`` (required); the bf16 first moment stays
    bf16."""
    return AdaFactorWState(
        step=_leaf_from_numpy(state.step, device).to(torch.int32),
        m=from_numpy(state.m, device), v_row=from_numpy(state.v_row, device),
        v_col=from_numpy(state.v_col, device))


def opt_state_to_numpy(state: AdaFactorWState) -> AdaFactorWState:
    """The port's optimizer state -> the same NamedTuple of numpy arrays
    (the bf16 first moment widened to float32, exactly)."""
    return AdaFactorWState(step=to_numpy(state.step), m=to_numpy(state.m),
                           v_row=to_numpy(state.v_row),
                           v_col=to_numpy(state.v_col))


def _cache_type(c):
    """The port's cache class for a reference cache: by its fields, since
    the reference's classes are not imported here."""
    for cls in (KVCache, SSMCache):
        if tuple(getattr(c, "_fields", ())) == cls._fields:
            return cls
    raise TypeError(f"not a KVCache or SSMCache: {type(c).__name__}")


def caches_from_numpy(caches, device) -> list:
    """The reference's decode caches (a list of ``KVCache``s or
    ``SSMCache``s of numpy arrays, its caller having run
    ``jax.device_get``) -> the port's, on ``device`` (required), dtypes
    kept."""
    return [_cache_type(c)(*(_leaf_from_numpy(x, device) for x in c))
            for c in caches]


def caches_to_numpy(caches) -> list:
    """The port's decode caches -> the same list of ``KVCache``s or
    ``SSMCache``s of numpy arrays (bf16 widened to float32, exactly)."""
    return [_cache_type(c)(*(to_numpy(x) for x in c)) for c in caches]


def to_device(tree, device):
    """The same tree with every tensor on ``device`` (no copy where a
    tensor is there already)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)
