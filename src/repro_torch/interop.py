"""Parameters between the reference and the port.

The reference keeps its parameters as a pytree of nested dicts and lists;
the port keeps the same tree with the same leaf paths, including the
stacked ``blocks`` layout (one list entry per layer-period position, all
layers on a leading axis), so each leaf maps one to one and the conversion
is a copy. The reference's tree comes in as numpy arrays (its caller runs
``jax.device_get``); this module imports nothing of the reference.

``init_params`` draws a fresh dual encoder with the reference's init law
from a ``torch.Generator``. ``opt_state_from_numpy`` / ``opt_state_to_numpy``
carry an AdaFactorW state (the reference's ``AdaFactorWState`` as numpy
arrays) both ways, with the same rule: every conversion onto torch names
its device, there is no default.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.dual_encoder import init_params  # noqa: F401
from repro_torch.optim.adafactorw import AdaFactorWState
from repro_torch.tree import leaves  # noqa: F401


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


def to_device(tree, device):
    """The same tree with every tensor on ``device`` (no copy where a
    tensor is there already)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)
