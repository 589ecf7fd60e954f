"""Meshes of the port (counterpart of ``repro/launch/mesh.py``): one
``torch.distributed`` rank per mesh device.

A ``Mesh`` names its axes and their sizes, as a JAX mesh does
(``mesh.shape["data"]``), so the sharding rules (``core.sharding``) read
it the same way. A mesh made by ``make_local_mesh`` lays the live ranks
out as the (data D, model M) grid of ``jax.make_mesh((D, M))``: rank r is
(data r // M, model r % M). It carries three groups of ranks, each an
``Axis`` with its process group, its extent, this rank's index in it and
its collectives (``all_gather``, ``all_reduce``, ``reduce_scatter``,
``barrier``):

  ``mesh.batch``  every rank, in rank order: the global batch is split
                  over all D·M of them (paper §5.1, "each core processes
                  B/2048 examples, regardless of R"), so the cross-shard
                  loss and the gradient sums of replicated leaves run here;
  ``mesh.data``   the ranks of this rank's model index, one per data
                  shard: a part of a weight split over the model axis has
                  its gradient summed over them;
  ``mesh.model``  the ranks of this rank's data index: a weight split over
                  the model axis is gathered, and its gradient
                  reduce-scattered, over them (``core.weight_sharding``);
                  under ``tp`` its ranks run the same examples and
                  all-reduce activations (``core.tensor_parallel``).

Under ``tp`` the global batch is split over the data group alone, so
that group takes the batch group's part: an ``Axis`` answers to
``ranks`` and ``rank`` as a mesh does, and the cross-shard loss runs over
``mesh.data``.

The mesh's own collectives are the batch group's. An axis of one rank (or
a mesh without a process group) runs no collective: its operations are
identities, so the single-device path issues none.
``make_production_mesh`` keeps the reference's pod shapes as metadata for
the sharding rules. ``fake_world`` stands one process in as rank 0 of a
world of any size, through torch's ``fake`` process group, whose
collectives move nothing: the dry run (``launch.dryrun``) and
``launch.memstats --devices`` trace a rank's step on ``meta`` tensors
there.

NCCL runs one rank per card. Several ranks sharing one card (NCCL refuses
that) use gloo, whose collectives on CUDA tensors are limited (no
all-gather or reduce-scatter of CUDA tensors): on a gloo group a CUDA
tensor is copied to the host, reduced there and copied back, giving the
same numbers. Only the gloo branch stages through the host; NCCL runs on
the device.
"""
from __future__ import annotations

from typing import Dict, Optional

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, unflatten

POD, DATA, MODEL = "pod", "data", "model"
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Axis:
    """A group of live ranks: its process ``group`` (None: no ranks to
    talk to), its ``size``, this rank's ``index`` in it, and the
    collectives over it. With one rank, or no group, every collective is
    an identity."""

    def __init__(self, group=None, size: int = 1, index: int = 0):
        self.group, self.size, self.index = group, int(size), int(index)

    @property
    def ranks(self) -> int:
        """``size``, under the name a ``Mesh`` gives its batch group's
        extent: an axis is a group the cross-shard loss can run over
        (``core.distributed_loss``; the data group under ``tp``)."""
        return self.size

    @property
    def rank(self) -> int:
        """``index``, under the name a ``Mesh`` gives it."""
        return self.index

    @property
    def distributed(self) -> bool:
        """True when the group spans more than one live rank."""
        return self.group is not None and self.size > 1

    @property
    def backend(self) -> Optional[str]:
        """'nccl' or 'gloo' for a distributed axis, else None."""
        return dist.get_backend(self.group) if self.distributed else None

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        # gloo takes CUDA tensors in few collectives: stage them on the host
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.detach().cpu()
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: (size, *t.shape) on
        ``t``'s device (``t[None]`` with one rank)."""
        if not self.distributed:
            return t[None]
        src = self._staged(t.contiguous())
        if self.backend == "gloo":
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            return torch.stack(parts).to(t.device)
        out = torch.empty((self.size, *t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` ('sum' or 'max') of ``t`` over the ranks, as a new tensor
        on ``t``'s device (``t`` itself with one rank)."""
        if not self.distributed:
            return t
        buf = self._staged(t).clone()
        dist.all_reduce(buf, op=_OPS[op], group=self.group)
        return buf.to(t.device)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """t: (size, *block) on every rank; returns the sum over ranks of
        ``t[own index]``, shaped ``block``."""
        if not self.distributed:
            return t[0]
        if self.backend == "gloo":
            # gloo has no reduce-scatter: sum everything, keep the own block
            return self.all_reduce(t)[self.index]
        out = torch.empty(t.shape[1:], dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
        return out

    def barrier(self) -> None:
        """Wait for every rank (no-op with one)."""
        if self.distributed:
            dist.barrier(group=self.group)


class Mesh:
    """Axis sizes (``shape``, ordered like a JAX mesh's) and, for a mesh of
    live ranks, the batch group ``group`` (every rank), this rank's
    ``data_index`` along the data axes (pod-major) and ``model_index``
    along the model axis, and the process groups of the data and model
    axes (by default the batch group, which each equals when the other
    axis has one rank). ``group=None`` is a mesh of one rank, or a
    metadata-only mesh (``make_production_mesh``) that runs no
    collective."""

    def __init__(self, shape: Dict[str, int], group=None,
                 data_index: int = 0, model_index: int = 0, *,
                 data_group=None, model_group=None):
        self.shape = dict(shape)
        self.group = group
        self.data_index = int(data_index)
        self.model_index = int(model_index)
        self.batch = Axis(group, self.data_size * self.model_size,
                          self.data_index * self.model_size
                          + self.model_index)
        self.data = Axis(group if data_group is None else data_group,
                         self.data_size, self.data_index)
        self.model = Axis(group if model_group is None else model_group,
                          self.model_size, self.model_index)

    @property
    def data_size(self) -> int:
        """Data shards (the data axes' product)."""
        n = 1
        for a in (POD, DATA):
            n *= self.shape.get(a, 1)
        return n

    @property
    def model_size(self) -> int:
        """Extent of the model axis (1 when the mesh has none)."""
        return self.shape.get(MODEL, 1)

    @property
    def ranks(self) -> int:
        """Ranks the batch is split over: data shards × model ranks."""
        return self.batch.size

    @property
    def rank(self) -> int:
        """This rank's place in the batch group, data_index · model_size +
        model_index: the row-major order of the (data, model) grid."""
        return self.batch.index

    @property
    def distributed(self) -> bool:
        """True when the mesh spans more than one live rank."""
        return self.batch.distributed

    @property
    def backend(self) -> Optional[str]:
        """'nccl' or 'gloo' for a distributed mesh, else None."""
        return self.batch.backend

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return (f"Mesh({axes}; rank {self.rank}"
                f"{', ' + self.backend if self.distributed else ''})")

    # -- collectives over the batch group (every rank) ----------------------
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``Axis.all_gather`` over every rank."""
        return self.batch.all_gather(t)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``Axis.all_reduce`` over every rank."""
        return self.batch.all_reduce(t, op)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``Axis.reduce_scatter`` over every rank."""
        return self.batch.reduce_scatter(t)

    def barrier(self) -> None:
        """Wait for every rank (no-op with one)."""
        self.batch.barrier()


def all_reduce_tree(tree, mesh, op: str = "sum",
                    bucket_bytes: int = 1 << 30):
    """``op`` of every leaf of ``tree`` over the ranks of ``mesh`` (a
    ``Mesh``, whose collectives are its batch group's, or one ``Axis``):
    the leaves of one dtype and device, in order, flattened into buckets
    of about ``bucket_bytes``, one all-reduce per bucket, cut back into
    ``tree``'s structure (``tree`` itself with one rank). The leaves come
    back as views of their bucket, so a bucket is freed once its leaves
    are (``AdaFactorW.apply`` releases them leaf by leaf)."""
    if not mesh.distributed:
        return tree
    flat = tree_leaves(tree)
    buckets, size = {}, {}
    for i, t in enumerate(flat):
        key = (t.dtype, t.device)
        nbytes = t.numel() * t.element_size()
        if key not in buckets or size[key] + nbytes > bucket_bytes:
            buckets.setdefault(key, []).append([])
            size[key] = 0
        buckets[key][-1].append(i)
        size[key] += nbytes
    out = [None] * len(flat)
    for idx in (b for runs in buckets.values() for b in runs):
        summed = mesh.all_reduce(torch.cat([flat[i].reshape(-1)
                                            for i in idx]), op)
        for i, part in zip(idx, torch.split(summed, [flat[i].numel()
                                                     for i in idx])):
            out[i] = part.view_as(flat[i])
    return unflatten(tree, out)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's pods as metadata: (data=16, model=16), or (pod=2,
    data=16, model=16). No ranks: for the sharding rules only."""
    if multi_pod:
        return Mesh({POD: 2, DATA: 16, MODEL: 16})
    return Mesh({DATA: 16, MODEL: 16})


def make_local_mesh(model: int = 1) -> Mesh:
    """The mesh of the live ranks: (data = world size / ``model``,
    ``model``), rank r at (data r // model, model r % model), as
    ``jax.make_mesh((data, model))`` orders its devices. Every rank creates
    the process groups of every data and model axis in the same order
    (``dist.new_group`` is collective); an axis that spans the whole world
    uses the default group. Without a process group the world is one
    rank. Raises ValueError when the world does not divide by ``model``."""
    if model < 1:
        raise ValueError(f"model={model}: the model axis needs at least "
                         f"one rank")
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if world % model:
        raise ValueError(f"model={model}: the world of {world} rank(s) does "
                         f"not divide into model groups of {model}")
    if world == 1:
        return Mesh({DATA: 1, MODEL: 1})
    data, whole = world // model, dist.group.WORLD
    data_groups = [whole if model == 1 else
                   dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [whole if data == 1 else
                    dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    return Mesh({DATA: data, MODEL: model}, group=whole,
                data_index=rank // model, model_index=rank % model,
                data_group=data_groups[rank % model],
                model_group=model_groups[rank // model])


@contextlib.contextmanager
def fake_world(shape):
    """This process as rank 0 of a world of ``prod(shape)`` ranks on a
    ``fake`` process group (``torch.testing``'s ``FakeStore``): yields the
    (data, model) mesh of ``make_local_mesh(model=shape[-1])`` (the data
    axes' product as the data extent), whose collectives return at once
    and leave their outputs as they were allocated. A world of one rank
    starts no group. The group is destroyed on exit. Raises RuntimeError
    where a process group is running already."""
    ranks = math.prod(shape)
    if ranks == 1:
        yield make_local_mesh()
        return
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process "
                           "group; one is running")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield make_local_mesh(model=shape[-1])
    finally:
        dist.destroy_process_group()
