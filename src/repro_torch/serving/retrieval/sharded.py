"""Device-sharded exact similarity→top-k (port of
``repro/serving/retrieval/sharded.py``, DESIGN.md §13.1).

The fused kernel never materialises the (b, n) logit matrix but runs on
one device: at 10M+ gallery or class rows one device can neither hold the
matrix nor sweep it at interactive latency. This module splits the row
axis over a mesh of devices and runs the fused kernel per shard, each
sweeping only its n / S rows:

  1. per shard: ``similarity_topk`` over the local (n_local, d) block with
     ``n_valid`` = the shard's real rows (the last shard's zero-padded
     tail scores NEG), its (b, k) winners lifted to global ids by the
     shard's row offset and the dead entries (NEG values) turned into the
     empty slot (NEG, IDX_PAD), so they can never alias a real row;
  2. combine: the S small (b, k) pools go to the query's device, and one
     ``merge_topk`` select-max-retire pass over the (b, S·k) pool gives
     the answer.

Exactness: every logit is one fp32-accumulated dot of a query row with a
class row, the same arithmetic whichever shard computes it, and a global
top-k winner is necessarily inside its own shard's top-k (at most k - 1
better rows exist anywhere). The merge rule (descending value, ties to the
lower global id) does not depend on the pool's order, so merging the
shards' top-ks gives the single-device sweep's answer bit for bit, ties
included.

Port design: the reference is single-controller (one process, a 1-D
``("data",)`` JAX mesh over its local devices, one fused sweep per shard
inside ``shard_map``, an all-gather of the winners, one merge). Here the
server is one process too, and its mesh is an ordered sequence of
``torch.device``s (``default_data_mesh(n)``: the first n CUDA devices). A
``ShardedMatrix`` holds one zero-padded (n_local, d) block per device,
n_local = max(ceil(n / S), MAX_K); a query is copied to every device
first, then every shard's kernel launches on its own device with no host
synchronisation between the launches, and the pools are copied to the
query's device and merged there. No
``torch.distributed``: the collective is S device-to-device copies of
(b, k). A mesh may name one device several times (``[cuda:0] * 4``, or
``[cpu] * 4`` in the tests): the shards then run one after another there,
with the same answer. A mesh of one device degenerates to the fused
kernel on it, as the reference's one-extent mesh does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.similarity_topk import ops as topk_ops
from repro_torch.kernels.similarity_topk.ops import IDX_PAD, NEG


def default_data_mesh(n_devices: Optional[int] = None):
    """The first ``n_devices`` CUDA devices (all of them by default), in
    order: the serving default when no mesh is passed in."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is available for the default "
                           "mesh; pass a mesh of devices")
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"n_devices={n} outside [1, {count}]")
    return tuple(torch.device("cuda", i) for i in range(n))


@dataclasses.dataclass(frozen=True)
class ShardedMatrix:
    """A class / gallery matrix split by rows over a mesh: block r (on
    ``mesh[r]``) holds rows [r·n_local, (r + 1)·n_local), zero-padded to
    ``n_local`` rows; the padding is masked at query time through the
    kernel's ``n_valid``. Build once with ``shard_matrix``; every
    ``sharded_similarity_topk`` call against it then moves no matrix
    rows."""
    blocks: tuple        # S tensors (n_local, d), contiguous
    n: int               # real (unpadded) row count
    n_local: int         # rows per shard (>= MAX_K)

    @property
    def n_shards(self) -> int:
        return len(self.blocks)

    @property
    def mesh(self) -> tuple:
        return tuple(b.device for b in self.blocks)

    @property
    def d(self) -> int:
        return int(self.blocks[0].shape[1])

    def n_valid(self, r: int) -> int:
        """The real rows of shard ``r``."""
        return int(min(max(self.n - r * self.n_local, 0), self.n_local))


def shard_matrix(matrix, mesh: Optional[Sequence] = None) -> ShardedMatrix:
    """Split ``matrix`` (n, d; numpy, taken as fp32, or a tensor on any
    device, its dtype kept) over ``mesh`` (default ``default_data_mesh()``)
    in blocks of n_local = max(ceil(n / S), MAX_K) rows, so any legal k
    fits in one shard; each block is written on its device, the last ones
    zero-padded."""
    mesh = default_data_mesh() if mesh is None else \
        tuple(torch.device(d) for d in mesh)
    if not mesh:
        raise ValueError("empty mesh")
    src = matrix if isinstance(matrix, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(matrix, np.float32))
    if src.dim() != 2:
        raise ValueError(f"expected an (n, d) matrix, got {tuple(src.shape)}")
    n, d = src.shape
    s = len(mesh)
    n_local = max(-(-n // s), topk_ops.MAX_K)
    blocks = []
    for r, dev in enumerate(mesh):
        lo, hi = min(r * n_local, n), min((r + 1) * n_local, n)
        block = torch.zeros((n_local, d), dtype=src.dtype, device=dev)
        if hi > lo:
            block[:hi - lo].copy_(src[lo:hi])
        blocks.append(block)
    return ShardedMatrix(tuple(blocks), int(n), int(n_local))


def sharded_similarity_topk(query_emb, class_emb, k: int, *, mesh=None,
                            inv_tau: float = 1.0,
                            block_rows: Optional[int] = None):
    """Device-sharded drop-in for ``similarity_topk``, the same answer bit
    for bit: per-shard fused sweeps, then the top-k-of-top-k merge.

    query_emb: (b, d), numpy (taken as fp32, put on the mesh's first
    device) or a tensor (its device is where the pools merge); class_emb:
    a ``ShardedMatrix`` (the no-upload path) or a raw (n, d) matrix,
    sharded here over ``mesh``. Returns (values (b, k) fp32, indices (b,
    k) int32) on the query's device."""
    sm = class_emb if isinstance(class_emb, ShardedMatrix) else \
        shard_matrix(class_emb, mesh)
    n, d = sm.n, sm.d
    q = query_emb if isinstance(query_emb, torch.Tensor) else \
        torch.as_tensor(np.asarray(query_emb, np.float32),
                        device=sm.mesh[0])
    if q.dim() != 2 or q.shape[1] != d:
        raise ValueError(f"embed dims differ: query {tuple(q.shape)} vs "
                         f"class {d}")
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, n={n}]")
    if k > topk_ops.MAX_K:
        raise ValueError(f"k={k} > MAX_K={topk_ops.MAX_K}")
    if sm.n_shards == 1:
        block = sm.blocks[0]
        return topk_ops.similarity_topk(
            q.to(block.device), block[:n], k, inv_tau=inv_tau,
            block_rows=block_rows)

    # every copy of the query first: a copy waits for the work queued on
    # the query's device, which would hold a shard back behind shard 0
    qs = [q.to(block.device, non_blocking=True) for block in sm.blocks]
    pools_v, pools_i = [], []
    for r, block in enumerate(sm.blocks):
        v, i = topk_ops.similarity_topk(
            qs[r], block, k, inv_tau=inv_tau, block_rows=block_rows,
            n_valid=sm.n_valid(r))
        # a shard with fewer than k valid rows emits NEG entries under
        # masked ids: they become empty slots, never real rows
        dead = v <= NEG / 2
        pools_v.append(torch.where(dead, NEG, v))
        pools_i.append(torch.where(dead, IDX_PAD, i + r * sm.n_local))
    pool_v = torch.cat([v.to(q.device) for v in pools_v], dim=1)
    pool_i = torch.cat([i.to(q.device) for i in pools_i], dim=1)
    return topk_ops.merge_topk(pool_v, pool_i, k)


def shard_winner_shares(indices, sm: ShardedMatrix) -> np.ndarray:
    """Per-shard share of the final top-k winners, the load-skew signal
    the serving telemetry histograms (``serve/retrieval_shard_share``).
    Returns (S,) fp32 summing to 1 (uniform ≈ balanced shards)."""
    idx = (indices.cpu().numpy() if isinstance(indices, torch.Tensor)
           else np.asarray(indices)).reshape(-1)
    shard_of = np.clip(idx // sm.n_local, 0, sm.n_shards - 1)
    counts = np.bincount(shard_of, minlength=sm.n_shards).astype(np.float64)
    total = max(counts.sum(), 1.0)
    return (counts / total).astype(np.float32)
