"""Sharding rules (port of ``repro/core/sharding.py``): the paper's §5.1
weight sharding and Megatron-style tensor parallelism, as metadata.

Modes
-----
``basic_ws`` (paper §5.1, the baseline): the global batch is split over
all cores (the data axes, ('pod', 'data')); weights and their optimizer
moments are split over the 'model' axis on their largest divisible dim and
gathered on use. 1-D params (norm scales, biases; §5.2 exception 1) stay
replicated.

``tp``: attention q/k/v and FFN-in shard their output dim over 'model',
o / FFN-out their input dim; MoE experts shard over 'model' when their
count divides it, else the expert's ff dim; embedding and LM head shard
the vocab when it divides.

``replicated``: every leaf replicated.

Functions here map a params / batch / cache tree to a tree of
``PartitionSpec``s: a ``P`` holds one entry per dim of its leaf (None, an
axis name, or a tuple of names), so a replicated leaf of n dims is n
Nones. A mesh is anything with a ``shape`` mapping of axis name to size
(``launch.mesh.Mesh``). ``shard`` places a tree by its specs: each rank
keeps its part of every leaf. The port's trainer places its params and
optimizer state by ``params_specs`` (a leaf split over 'model' is kept
as 1/M on each rank of the model axis and gathered on use by
``core.weight_sharding``) and its LM batch by ``batch_specs`` over
('data', 'model'), strictly: a batch that does not divide over every
rank raises instead of being replicated over the model axis. Under
``tp`` the same placement is executed Megatron-style
(``core.tensor_parallel``: the models compute with the parts, and the
batch is split over the data axes only); its rules are here, tested
against the reference's.
"""
from __future__ import annotations

import re
from typing import Callable, Optional

import torch

POD, DATA, MODEL = "pod", "data", "model"


class P(tuple):
    """A PartitionSpec: one entry per dim of its leaf, each None (not
    split), an axis name, or a tuple of axis names (a tuple of one name is
    kept as the name, as JAX's ``PartitionSpec`` keeps it)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and
                                     len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def mesh_axis_size(mesh, name) -> int:
    """Extent of mesh axis ``name`` (int), 1 when the mesh lacks it."""
    return mesh.shape[name] if name in mesh.shape else 1


def data_axes(mesh) -> tuple:
    """The batch-distribution axes of ``mesh``: ('pod', 'data') on
    multi-pod meshes, ('data',) otherwise."""
    return (POD, DATA) if POD in mesh.shape else (DATA,)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def _map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over ``tree``, keeping its dicts, lists, tuples
    and NamedTuples; paths read like the reference's
    (``image/tower/blocks/0/attn/wq``; a NamedTuple field ``.name``)."""
    def join(part):
        return f"{path}/{part}" if path else str(part)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, join(f".{f}"))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def spec_leaves(specs, path: str = ""):
    """(path, P) pairs of a spec tree, in its order."""
    if isinstance(specs, P):
        yield path, specs
    elif isinstance(specs, dict):
        for k, v in specs.items():
            yield from spec_leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(specs, (list, tuple)):
        fields = getattr(specs, "_fields", None)
        for i, v in enumerate(specs):
            part = f".{fields[i]}" if fields else i
            yield from spec_leaves(v, f"{path}/{part}" if path else str(part))


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------


def _shard_largest(shape, axis_size: int, skip=frozenset()) -> Optional[int]:
    """Index of the largest dim divisible by axis_size, or None."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if i in skip:
            continue
        if shape[i] % axis_size == 0 and shape[i] >= axis_size:
            return i
    return None


def _spec_with(ndim: int, axis: Optional[int], name) -> P:
    parts = [None] * ndim
    if axis is not None:
        parts[axis] = name
    return P(*parts)


# ---------------------------------------------------------------------------
# param specs
# ---------------------------------------------------------------------------


def params_specs(params, mesh, mode: str = "basic_ws"):
    """P tree matching ``params`` (LM and dual-encoder trees, and optimizer
    states over them; stacked block leaves are found by the 'blocks' path
    and their leading layer axis is never sharded)."""
    msize = mesh_axis_size(mesh, MODEL)

    def leaf_spec(name, x):
        shape = _shape(x)
        skip = {0} if "blocks" in name.split("/") else set()
        if len(shape) <= 1 or msize == 1:
            return P(*([None] * len(shape)))
        if mode == "basic_ws":
            return _spec_with(len(shape), _shard_largest(shape, msize, skip),
                              MODEL)
        if mode == "tp":
            return _tp_leaf_spec(name, shape, msize, skip)
        if mode == "replicated":
            return P(*([None] * len(shape)))
        raise ValueError(f"unknown sharding mode {mode!r}")

    return _map_with_path(leaf_spec, params)


_TP_OUT = re.compile(r"(wq|wk|wv|wi|wg|in_z|in_x|in_B|in_C|in_dt|proj"
                     r"|dense_wi|dense_wg|lm_head)$")
_TP_IN = re.compile(r"(wo|out|dense_wo)$")


def _tp_leaf_spec(name: str, shape, msize: int, skip) -> P:
    last = name.rsplit("/", 1)[-1]
    nd = len(shape)
    is_moe = "/moe/" in f"/{name}/" and last in ("wi", "wg", "wo")
    if is_moe:
        # expert axis is right after the (optional) stacked layer axis
        e_ax = 1 if 0 in skip else 0
        if shape[e_ax] % msize == 0:
            return _spec_with(nd, e_ax, MODEL)          # expert parallel
        # fall back to intra-expert TP on the ff dim
        ff_ax = nd - 1 if last in ("wi", "wg") else nd - 2
        if shape[ff_ax] % msize == 0:
            return _spec_with(nd, ff_ax, MODEL)
        return _spec_with(nd, None, MODEL)
    if last == "router":
        return _spec_with(nd, None, MODEL)
    if last == "embed":
        ax = 0 if shape[0] % msize == 0 else (1 if shape[1] % msize == 0
                                              else None)
        return _spec_with(nd, ax, MODEL)
    if last == "conv_w":
        ax = nd - 1 if shape[-1] % msize == 0 else None
        return _spec_with(nd, ax, MODEL)
    if _TP_OUT.search(last):
        ax = nd - 1 if shape[-1] % msize == 0 else None
        if ax is None:  # fall back: shard input dim
            ax = nd - 2 if nd >= 2 and shape[-2] % msize == 0 else None
        return _spec_with(nd, ax, MODEL)
    if _TP_IN.search(last):
        ax = nd - 2 if shape[-2] % msize == 0 else None
        if ax is None:
            ax = nd - 1 if shape[-1] % msize == 0 else None
        return _spec_with(nd, ax, MODEL)
    # unknown 2D+ leaf: basic_ws-style largest-dim fallback
    return _spec_with(nd, _shard_largest(shape, msize, skip), MODEL)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(batch, mesh, *, batch_axes=None, strict: bool = False):
    """Shard the leading (batch) dim of every input leaf over the data
    axes (or ``batch_axes``), dropping axes that do not divide it, as the
    reference does. ``strict=True`` raises ValueError instead of dropping
    an axis: the trainer's rule, since a batch replicated over the model
    axis would compute every example M times."""
    if batch_axes is None:
        batch_axes = data_axes(mesh)

    def leaf(path, x):
        shape = _shape(x)
        if not shape:
            return P()
        axes, prod = [], 1
        for a in batch_axes:
            n = mesh_axis_size(mesh, a)
            if shape[0] % (prod * n) == 0:
                axes.append(a)
                prod *= n
            elif strict:
                raise ValueError(
                    f"batch leaf {path or 'the root'} of {shape[0]} rows "
                    f"does not divide over the mesh axes {tuple(batch_axes)}"
                    f" ({prod * n} ranks would take equal blocks)")
        return P(tuple(axes) if axes else None, *([None] * (len(shape) - 1)))

    return _map_with_path(leaf, batch)


def cache_specs(caches, mesh, *, seq_axis_names=(MODEL,)):
    """Decode caches: batch dim over the data axes when divisible;
    otherwise (batch 1 at long context) shard the cache's sequence axis
    (context parallel).

    KV cache leaves: (n_periods, b, kv_heads, S, hd);
    SSM state leaves: (n_periods, b, heads, p, n) / conv (n_periods, b,
    cw-1, c)."""
    daxes = data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= mesh_axis_size(mesh, a)
    msize = mesh_axis_size(mesh, MODEL)

    def leaf(_, x):
        shape = _shape(x)
        nd = len(shape)
        parts = [None] * nd
        if nd < 2:
            return P(*parts)
        rest = sorted(range(2, nd), key=lambda i: -shape[i])
        if shape[1] % dsize == 0:
            parts[1] = daxes if len(daxes) > 1 else daxes[0]
            # additionally shard the longest remaining dim over model
            for i in rest:
                if shape[i] % msize == 0 and shape[i] >= 16:
                    parts[i] = MODEL
                    break
        else:
            # batch too small: context-parallel the biggest axis over
            # (data, model) combined when divisible, else over model only
            for i in rest:
                if shape[i] % (dsize * msize) == 0 and \
                        shape[i] >= dsize * msize:
                    parts[i] = (*daxes, MODEL)
                    break
                if shape[i] % msize == 0 and shape[i] >= msize:
                    parts[i] = MODEL
                    break
        return P(*parts)

    return _map_with_path(leaf, caches)


def local_part(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's part of ``x`` under ``spec``: each dim split over mesh
    axes is cut into equal blocks, one per position along those axes (the
    first axis named major), and the rank keeps its own (``x`` itself when
    nothing is split over an axis of more than one). The rank's position
    is ``mesh.data_index`` along the data axes (pod-major) and
    ``mesh.model_index`` along the model axis. A view of ``x``."""
    coord = {POD: mesh.data_index // mesh_axis_size(mesh, DATA),
             DATA: mesh.data_index % mesh_axis_size(mesh, DATA),
             MODEL: getattr(mesh, "model_index", 0)}
    for dim, part in enumerate(spec):
        names = () if part is None else \
            (part if isinstance(part, tuple) else (part,))
        n = 1
        for a in names:
            n *= mesh_axis_size(mesh, a)
        if n == 1:
            continue
        index = 0
        for a in names:
            index = index * mesh_axis_size(mesh, a) + coord[a]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} is not "
                             f"divisible by the extent {n} of {names}")
        b = x.shape[dim] // n
        x = x.narrow(dim, index * b, b)
    return x


def shard(tree, specs, mesh):
    """``tree`` with every leaf cut to this rank's part under its spec in
    ``specs`` (a tree of ``P`` from ``params_specs`` / ``batch_specs`` /
    ``cache_specs``): the port's placement of a tree onto the live mesh.
    A leaf that is not a tensor is kept."""
    if isinstance(specs, P):
        return local_part(tree, specs, mesh) \
            if isinstance(tree, torch.Tensor) else tree
    if isinstance(tree, dict):
        return {k: shard(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard(v, sp, mesh)
                            for v, sp in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard(v, sp, mesh) for v, sp in zip(tree, specs))
    return tree
