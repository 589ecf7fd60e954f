"""Meshes of the port (counterpart of ``repro/launch/mesh.py``): one
``torch.distributed`` rank per mesh device.

A ``Mesh`` names its axes and their sizes, as a JAX mesh does
(``mesh.shape["data"]``), so the sharding rules (``core.sharding``) read
it the same way. A mesh made by ``make_local_mesh`` also carries the
process group of its data axis and this rank's index along it, and runs
the collectives the cross-shard loss and the trainer need: ``all_gather``,
``all_reduce``, ``reduce_scatter`` and ``barrier``. With
one rank (no process group, or a world of 1) they are identities, so the
single-device path issues no collective at all.

The port applies only the data axis: the batch is split over the ranks
and every parameter is replicated. A model axis larger than 1 (Megatron
tensor parallelism, the paper's §5.1 weight sharding) is refused here and
comes with the tensor-parallel slice of the port. ``make_production_mesh``
keeps the reference's pod shapes as metadata for the sharding rules.

NCCL runs one rank per card. Several ranks sharing one card (NCCL refuses
that) use gloo, whose collectives on CUDA tensors are limited (no
all-gather or reduce-scatter of CUDA tensors): on a gloo group a CUDA
tensor is copied to the host, reduced there and copied back, giving the
same numbers. Only the gloo branch stages through the host; NCCL runs on
the device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, unflatten

POD, DATA, MODEL = "pod", "data", "model"
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """Axis sizes (``shape``, ordered like a JAX mesh's) and, for a mesh of
    live ranks, the data axis's process ``group`` and this rank's
    ``data_index`` on it. ``group=None`` is a mesh of one rank, or a
    metadata-only mesh (``make_production_mesh``) that runs no
    collective."""

    def __init__(self, shape: Dict[str, int], group=None,
                 data_index: int = 0):
        self.shape = dict(shape)
        self.group = group
        self.data_index = int(data_index)

    @property
    def data_size(self) -> int:
        """Ranks the batch is split over (the data axes' product)."""
        n = 1
        for a in (POD, DATA):
            n *= self.shape.get(a, 1)
        return n

    @property
    def distributed(self) -> bool:
        """True when the data axis spans more than one live rank."""
        return self.group is not None and self.data_size > 1

    @property
    def backend(self) -> Optional[str]:
        """'nccl' or 'gloo' for a distributed mesh, else None."""
        return dist.get_backend(self.group) if self.distributed else None

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return (f"Mesh({axes}; rank {self.data_index}"
                f"{', ' + self.backend if self.distributed else ''})")

    # -- collectives over the data axis -------------------------------------
    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        # gloo takes CUDA tensors in few collectives: stage them on the host
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.detach().cpu()
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: (R, *t.shape) on
        ``t``'s device (``t[None]`` with one rank)."""
        if not self.distributed:
            return t[None]
        src = self._staged(t.contiguous())
        if self.backend == "gloo":
            parts = [torch.empty_like(src) for _ in range(self.data_size)]
            dist.all_gather(parts, src, group=self.group)
            return torch.stack(parts).to(t.device)
        out = torch.empty((self.data_size, *t.shape), dtype=t.dtype,
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
        """t: (R, *block) on every rank; returns the sum over ranks of
        ``t[own rank]``, shaped ``block``."""
        if not self.distributed:
            return t[0]
        if self.backend == "gloo":
            # gloo has no reduce-scatter: sum everything, keep the own block
            return self.all_reduce(t)[self.data_index]
        out = torch.empty(t.shape[1:], dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
        return out

    def barrier(self) -> None:
        """Wait for every rank (no-op with one)."""
        if self.distributed:
            dist.barrier(group=self.group)


def all_reduce_tree(tree, mesh, op: str = "sum"):
    """``op`` of every leaf of ``tree`` over the mesh's ranks: the leaves
    of one dtype and device flattened into one buffer, one all-reduce per
    buffer, cut back into ``tree``'s structure (``tree`` itself with one
    rank)."""
    if not mesh.distributed:
        return tree
    flat = tree_leaves(tree)
    buckets = {}
    for i, t in enumerate(flat):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    out = [None] * len(flat)
    for idx in buckets.values():
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
    """The mesh of the live ranks: (data = world size / model, model), the
    data axis over the default process group (a mesh of one rank when no
    group is initialised). ``model > 1`` raises NotImplementedError: tensor
    parallelism comes with the tensor-parallel slice of the port."""
    if model != 1:
        raise NotImplementedError(
            f"model={model}: tensor parallelism and weight sharding across "
            f"ranks come with the tensor-parallel slice of the port; this "
            f"port runs a data axis only (model=1)")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh({DATA: 1, MODEL: 1})
    world = dist.get_world_size()
    return Mesh({DATA: world, MODEL: 1}, group=dist.group.WORLD,
                data_index=dist.get_rank())
