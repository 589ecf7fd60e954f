"""Paper §5.1 weight sharding across ranks: each rank of the model axis
keeps 1/M of every weight the ``basic_ws`` rule splits, and gathers a
weight only while it is being used.

The reference leaves this to XLA (its params carry ``NamedSharding``s from
``core.sharding.params_specs`` and the compiler inserts the gathers). The
port states it. A ``Layout`` holds, for every leaf of a params tree, the
dim split over the model axis (None: the leaf is whole on every rank) and
that axis (``launch.mesh.Axis``, ``mesh.model``). ``gather`` turns a
subtree of parts into whole leaves through ``_Gather``, an autograd
``Function`` whose forward all-gathers the parts over the model group and
whose backward reduce-scatters the whole gradient back to parts: the M
ranks of a model group ran the weight on different examples, so their
gradients sum. The models call ``gather`` on one layer's leaves inside the
function ``core.remat`` wraps (``models.transformer.forward``), so a
recomputed block gathers its weights again instead of holding every layer
whole, and its gradient is a part as soon as that layer's backward ends.

``cut`` takes a rank's parts of whole leaves (a fresh copy, so the whole
tree can be freed), ``whole_like`` the whole shapes of a tree of parts as
``meta`` tensors, ``gather_leaf`` one whole leaf outside autograd (the
checkpoint's save), ``sum_grads`` the step's gradient sum over the ranks
and ``sq_norm`` the squared norm of a tree whose split leaves are parts.
Every function takes ``layout=None`` for a tree of whole leaves and then
does nothing. A layout of mode 'tp' places the leaves the same way, but
the models do not gather them (``core.tensor_parallel``); ``cut``,
``whole_like``, ``gather_leaf``, ``sq_norm`` and the optimizer's parts
serve both rules.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sharding as shd
from repro_torch.launch.mesh import all_reduce_tree
from repro_torch.tree import tree_leaves, tree_map, unflatten


class Layout:
    """Where a tree's leaves live over the model axis: ``dims`` is a tree
    with the params' structure holding, per leaf, the dim split over
    ``axis`` (an int) or None; ``axis`` is the model axis
    (``launch.mesh.Axis``); ``mode`` the rule that placed them:
    'basic_ws' (the models gather the parts on use, this module) or 'tp'
    (the models compute with the parts as they lie,
    ``core.tensor_parallel``). ``layout[key]`` is the layout of a
    subtree."""

    def __init__(self, dims, axis, mode: str = "basic_ws"):
        self.dims, self.axis, self.mode = dims, axis, mode

    def __getitem__(self, key) -> "Layout":
        return Layout(self.dims[key], self.axis, self.mode)

    @property
    def flat_dims(self) -> list:
        """The leaves' split dims in ``tree.leaves`` order."""
        return tree_leaves(self.dims)


def from_specs(specs, mesh, mode: str = "basic_ws") -> Optional[Layout]:
    """The layout of a params tree placed by ``core.sharding.params_specs``
    on ``mesh`` under the rule ``mode``: each leaf's dim whose spec names
    the model axis. None when the model axis has one rank or no leaf is
    split (every leaf is then whole on every rank)."""
    def dim_of(spec):
        for d, part in enumerate(spec):
            names = part if isinstance(part, tuple) else (part,)
            if shd.MODEL in names:
                return d
        return None
    dims = _map_specs(dim_of, specs)
    if mesh.model_size == 1 or all(d is None for d in tree_leaves(dims)):
        return None
    return Layout(dims, mesh.model, mode)


def _map_specs(fn, specs):
    if isinstance(specs, shd.P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return [_map_specs(fn, v) for v in specs]


def sub(layout: Optional[Layout], *keys) -> Optional[Layout]:
    """``layout[k0][k1]...``, or None for a tree of whole leaves."""
    for k in keys:
        if layout is None:
            return None
        layout = layout[k]
    return layout


def layer(layout: Optional[Layout]) -> Optional[Layout]:
    """The layout of one layer of stacked block leaves: the leading layer
    axis, never split (``params_specs`` skips it), is sliced away."""
    if layout is None:
        return None
    return Layout(tree_map(lambda d: None if d is None else d - 1,
                           layout.dims), layout.axis, layout.mode)


class _Gather(torch.autograd.Function):
    """The whole leaf from the model group's parts along ``dim`` (rank
    order); the backward reduce-scatters the whole gradient, summing the
    ranks' contributions, and returns this rank's part of it."""

    @staticmethod
    def forward(ctx, part, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _joined(axis.all_gather(part), dim)

    @staticmethod
    def backward(ctx, g):
        dim, n = ctx.dim, ctx.axis.size
        b = g.shape[dim] // n
        parts = g.reshape(*g.shape[:dim], n, b, *g.shape[dim + 1:])
        return ctx.axis.reduce_scatter(parts.movedim(dim, 0)), None, None


def _joined(stacked: torch.Tensor, dim: int) -> torch.Tensor:
    """(n, *part) parts in rank order -> the whole leaf, joined along
    ``dim``."""
    n, part = stacked.shape[0], stacked.shape[1:]
    whole = stacked.movedim(0, dim)
    return whole.reshape(*part[:dim], n * part[dim], *part[dim + 1:])


def gather(tree, layout: Optional[Layout]):
    """``tree`` (a subtree of parts, or one part) with every split leaf
    gathered whole over the model group, differentiably (``_Gather``);
    ``tree`` itself without a layout."""
    if layout is None:
        return tree
    return tree_map(lambda x, d: x if d is None else
                    _Gather.apply(x, d, layout.axis), tree, layout.dims)


@torch.no_grad()
def gather_leaf(x: torch.Tensor, dim: Optional[int], axis) -> torch.Tensor:
    """One whole leaf from its parts (``x`` itself when ``dim`` is None),
    outside autograd."""
    return x if dim is None else _joined(axis.all_gather(x), dim)


@torch.no_grad()
def cut_leaf(x: torch.Tensor, d: Optional[int], axis) -> torch.Tensor:
    """This rank's part of the whole leaf ``x`` split on ``d`` over
    ``axis``, as a fresh tensor (``x`` itself when ``d`` is None)."""
    if d is None:
        return x
    if x.shape[d] % axis.size:
        raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                         f"over {axis.size} model ranks")
    b = x.shape[d] // axis.size
    return x.narrow(d, axis.index * b, b).clone()


def cut(tree, layout: Optional[Layout]):
    """This rank's part of every split leaf of ``tree`` (whole leaves), as
    a fresh tensor, so the whole leaf can be freed; whole leaves are kept
    as they are (and the tree's structure, NamedTuples included)."""
    if layout is None:
        return tree
    return unflatten(tree, [cut_leaf(x, d, layout.axis) for x, d in
                            zip(tree_leaves(tree), layout.flat_dims)])


def whole_like(tree, layout: Optional[Layout]):
    """``meta`` stand-ins of the whole leaves of a tree of parts (its
    structure kept, NamedTuples included)."""
    n = 1 if layout is None else layout.axis.size
    flat = tree_leaves(tree)
    dims = [None] * len(flat) if layout is None else layout.flat_dims

    def like(x, d):
        shape = list(x.shape)
        if d is not None:
            shape[d] *= n
        return torch.empty(shape, dtype=x.dtype, device="meta")
    return unflatten(tree, [like(x, d) for x, d in zip(flat, dims)])


def sum_grads(grads, mesh, layout: Optional[Layout]):
    """The step's gradients summed over every rank of ``mesh``: a split
    leaf's part (already summed over its model group by ``_Gather``'s
    backward) over the data axis, a whole leaf over the batch group.
    Under ``tp`` the M ranks of a model group ran the same examples: a
    part's gradient is complete on its rank and a whole leaf's is the same
    on the M ranks, so every leaf is summed over the data axis alone."""
    if layout is None:
        return all_reduce_tree(grads, mesh)
    if layout.mode == "tp":
        return all_reduce_tree(grads, mesh.data)
    flat, dims = tree_leaves(grads), layout.flat_dims
    split = [i for i, d in enumerate(dims) if d is not None]
    whole = [i for i, d in enumerate(dims) if d is None]
    out = [None] * len(flat)
    for idx, axis in ((split, mesh.data), (whole, mesh)):
        for i, g in zip(idx, all_reduce_tree([flat[i] for i in idx], axis)):
            out[i] = g
    return unflatten(grads, out)


def sq_norm(tree, layout: Optional[Layout]) -> torch.Tensor:
    """Σ x² over the whole leaves of ``tree`` (fp32): the parts' sums of
    the split leaves are summed over the model group."""
    flat = tree_leaves(tree)
    dims = [None] * len(flat) if layout is None else layout.flat_dims
    whole = sum(torch.sum(x.float() ** 2) for x, d in zip(flat, dims)
                if d is None)
    parts = [torch.sum(x.float() ** 2) for x, d in zip(flat, dims)
             if d is not None]
    if parts:
        whole = whole + layout.axis.all_reduce(torch.stack(parts).sum())
    return whole
