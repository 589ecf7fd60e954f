"""Two-stage coarse→fine retrieval for the long tail (port of
``repro/serving/retrieval/twostage.py``, DESIGN.md §13.2).

Even sharded, an exact sweep touches every one of N rows; at N = 10M+ an
interactive latency budget only covers a pruned sweep. This is the
IVF-style trade: group the class / gallery rows into blocks around
k-means centroids (built once per registry artifact version, so a
checkpoint or tokenizer refresh invalidates the index with the matrix),
then per batch

  1. coarse: score the (b, P) query × centroid matrix (P ≈ √N blocks) and
     take each query's top-``nprobe`` blocks;
  2. prune:  the batch's surviving blocks are the union of the per-query
     probes; the candidate ids are their members, sorted ascending so the
     fused kernel's lower-local-index tie-break maps to the lower global
     id;
  3. rerank: exact ``similarity_topk`` sweeps over only the candidate
     rows, the local winners mapped back through the id table.

At ``nprobe >= n_blocks`` every block survives, the candidate table is
the identity and the rerank is the fused sweep itself: recall@k = 1 by
construction. At pruned settings recall is a measured trade against
latency.

Port design: the reference keeps the matrix in host numpy, gathers the
candidate rows there and uploads them each call, and builds the index
with host numpy. Here the matrix stays on its device: the coarse product
``q @ centroids.T`` runs there, the candidate rows are gathered there with
``index_select``, and the index is built there with the same spherical
k-means (the same initial rows, ``iters`` Lloyd rounds, re-normalised
member means, an empty block keeping its centroid, members ascending per
block). A block's member sum is a one-hot product summed over row chunks
in a fixed order, so the build gives the same bits on every run. Only
the union of probes (``_survivor_blocks``) stays numpy, on the small
(b, P) scores. Rows may still come from a ``gather(ids)`` callback (a
gallery streamed from elsewhere); they are moved to the query's device.
The ``.npz`` layout of ``CentroidIndex.save`` is the reference's, so an
index written by either package loads in the other.

The rerank gathers and sweeps the candidates in chunks of at most
``_RERANK_ELEMS`` matrix elements, so a wide probe (most blocks kept)
never copies the whole matrix. Each chunk's (b, k) winners are mapped to
global ids through the ascending candidate table and the pools are
merged by ``merge_topk``: ties go to the lower id in the sweep and in
the merge alike, so the answer is the one-sweep answer bit for bit (the
argument of ``sharded.py``). When every block survives there is no copy:
one sweep over the matrix itself, and the coarse product is skipped
(every block survives whatever the scores). Stage seconds come from CUDA
events, read once at the end of the call, after the rerank; the stages
themselves wait on the device only where the host needs its answer: the
pruned case's coarse scores and candidate count, and a callback's ids.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.kernels.similarity_topk import ops as topk_ops

# elements of the largest temporary a build step makes (a chunk of the
# (rows, P) score or one-hot matrix): 2^26 fp32, 256 MiB
_CHUNK_ELEMS = 2 ** 26
# elements of the largest candidate-row copy the rerank makes (one
# chunk): 2^28, 1 GiB in fp32
_RERANK_ELEMS = 2 ** 28


@dataclasses.dataclass(frozen=True)
class CentroidIndex:
    """The coarse index: unit-norm centroids plus the block membership
    table (a partition of [0, n)), on one device."""
    centroids: torch.Tensor  # (P, d) fp32 unit-norm
    members: torch.Tensor    # (P, m_max) int32 global ids, -1 padded
    counts: torch.Tensor     # (P,) int32 real member count per block
    n: int                   # total rows indexed

    @property
    def n_blocks(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @functools.cached_property
    def counts_host(self) -> np.ndarray:
        """``counts`` as host int32 (the prune works on the host)."""
        return self.counts.cpu().numpy()

    def block_members(self, block: int) -> torch.Tensor:
        """The global ids of ``block`` (ascending, unpadded)."""
        return self.members[block, :int(self.counts_host[block])]

    def to(self, device) -> "CentroidIndex":
        """This index with its tables on ``device``."""
        device = torch.device(device)
        if device == self.device:
            return self
        return CentroidIndex(self.centroids.to(device),
                             self.members.to(device),
                             self.counts.to(device), self.n)

    def save(self, path: str) -> None:
        """Persist as an .npz (atomic: tmp + rename), the reference's keys
        and dtypes."""
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, centroids=self.centroids.cpu().numpy(),
                     members=self.members.cpu().numpy(),
                     counts=self.counts.cpu().numpy(), n=np.int64(self.n))
        os.replace(tmp, path)

    @staticmethod
    def load(path: str, device="cpu") -> "CentroidIndex":
        """Inverse of ``save`` (either package's file), on ``device``."""
        with np.load(path) as z:
            return CentroidIndex(
                torch.as_tensor(z["centroids"], dtype=torch.float32,
                                device=device),
                torch.as_tensor(z["members"], dtype=torch.int32,
                                device=device),
                torch.as_tensor(z["counts"], dtype=torch.int32,
                                device=device),
                int(z["n"]))


def _rows(matrix, device=None) -> torch.Tensor:
    """``matrix`` (numpy or tensor) as an fp32 tensor on ``device`` (its
    own device when None and it is a tensor, else the CPU)."""
    if isinstance(matrix, torch.Tensor):
        return matrix.to(device=device or matrix.device,
                         dtype=torch.float32)
    return torch.as_tensor(np.asarray(matrix, np.float32),
                           device=device or "cpu")


def _assign(m: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Each row's max-cosine centroid (the first of equals), (n,) int64,
    over row chunks."""
    step = max(1, _CHUNK_ELEMS // cent.shape[0])
    return torch.cat([torch.argmax(m[i:i + step] @ cent.T, dim=1)
                      for i in range(0, m.shape[0], step)])


def _block_sums(m: torch.Tensor, assign: torch.Tensor, p: int
                ) -> torch.Tensor:
    """(p, d) sum of each block's member rows: one-hot (p, chunk) products
    added over the row chunks in order (no atomics: the same bits every
    run)."""
    step = max(1, _CHUNK_ELEMS // p)
    blocks = torch.arange(p, device=m.device)[:, None]
    out = torch.zeros((p, m.shape[1]), dtype=torch.float32, device=m.device)
    for i in range(0, m.shape[0], step):
        onehot = (assign[None, i:i + step] == blocks).to(torch.float32)
        out += onehot @ m[i:i + step]
    return out


def build_centroid_index(matrix, *, n_blocks: Optional[int] = None,
                         iters: int = 4, seed: int = 0,
                         device=None) -> CentroidIndex:
    """Spherical k-means over the (n, d) unit-norm ``matrix`` (numpy or a
    tensor), on ``device`` (default: the tensor's own, or the CPU).

    Deterministic for a given (matrix, n_blocks, iters, seed): init takes
    ``n_blocks`` evenly spaced rows (seed rotates the offset), each Lloyd
    iteration assigns rows to their max-cosine centroid and re-normalises
    the member sum; empty blocks keep their previous centroid. Defaults to
    P = ceil(sqrt(n)) blocks. The members are those of the last
    iteration's assignment, ascending per block."""
    m = _rows(matrix, device)
    n, d = m.shape
    if n == 0:
        raise ValueError("cannot index an empty matrix")
    p = int(n_blocks) if n_blocks else int(np.ceil(np.sqrt(n)))
    p = max(1, min(p, n))
    start = seed % max(n // p, 1)
    init = (start + (np.arange(p, dtype=np.int64) * n) // p) % n
    cent = m[torch.as_tensor(init, device=m.device)].clone()
    assign = None
    for _ in range(max(int(iters), 1)):
        assign = _assign(m, cent)
        sums = _block_sums(m, assign, p)
        norm = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
        cent = torch.where(norm > 0, sums / norm, cent)
    counts = torch.bincount(assign, minlength=p)
    m_max = max(int(counts.max()), 1)
    order = torch.sort(assign, stable=True).indices   # ascending ids
    owner = assign[order]
    pos = torch.arange(n, device=m.device) - (torch.cumsum(counts, 0)
                                              - counts)[owner]
    members = torch.full((p, m_max), -1, dtype=torch.int32, device=m.device)
    members[owner, pos] = order.to(torch.int32)
    return CentroidIndex(cent, members, counts.to(torch.int32), n)


def _survivor_blocks(index: CentroidIndex, scores: np.ndarray,
                     nprobe: int, min_candidates: int) -> np.ndarray:
    """Union of each query's top-``nprobe`` blocks, grown (best coarse
    score first) until it holds at least ``min_candidates`` rows, so a
    tiny nprobe can never starve the rerank below k candidates."""
    p = index.n_blocks
    counts = index.counts_host
    nprobe = min(int(nprobe), p)
    top = np.argpartition(-scores, nprobe - 1, axis=1)[:, :nprobe] \
        if nprobe < p else np.tile(np.arange(p), (scores.shape[0], 1))
    survivors = np.unique(top)
    have = int(counts[survivors].sum())
    if have < min_candidates:
        rest = np.setdiff1d(np.arange(p), survivors, assume_unique=True)
        rest = rest[np.argsort(-scores.max(axis=0)[rest], kind="stable")]
        for b in rest:
            survivors = np.append(survivors, b)
            have += int(counts[b])
            if have >= min_candidates:
                break
        survivors = np.sort(survivors)
    return survivors


class _Stages:
    """Seconds per named stage, summed over the intervals that end at a
    mark of that stage: CUDA events on a CUDA device (read once, after the
    last mark has run), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.current_stream(device) if self.cuda \
            else None
        self.marks = []
        self.mark(None)

    def mark(self, stage) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record(self.stream)
        else:
            event = time.perf_counter()
        self.marks.append((stage, event))

    def seconds(self) -> dict:
        if self.cuda:
            self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (stage, b) in zip(self.marks, self.marks[1:]):
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            out[stage] = out.get(stage, 0.0) + dt
        return out


def _rerank(q, matrix_or_gather, cand_ids, k, stages, **kw):
    """Exact top-k over the candidate rows ``cand_ids`` (ascending global
    ids on q's device), gathered and swept in chunks of at most
    ``_RERANK_ELEMS`` elements; the chunks' winners, mapped to global ids,
    are merged by ``merge_topk``. Returns (values, global ids)."""
    step = max(k, _RERANK_ELEMS // max(q.shape[1], 1))
    pools_v, pools_i = [], []
    for lo in range(0, len(cand_ids), step):
        ids = cand_ids[lo:lo + step]
        if callable(matrix_or_gather):
            rows = torch.as_tensor(matrix_or_gather(ids.cpu().numpy()))
            rows = rows.to(device=q.device, dtype=torch.float32).contiguous()
        else:
            rows = matrix_or_gather.index_select(0, ids)
        stages.mark("gather")
        vals, loc = topk_ops.similarity_topk(
            q.to(rows.dtype), rows, min(k, len(ids)), **kw)
        pools_v.append(vals)
        pools_i.append(ids[loc.long()])
        del rows            # the next chunk reuses its memory, in stream order
        stages.mark("rerank")
    if len(pools_v) == 1:
        return pools_v[0], pools_i[0]
    out = topk_ops.merge_topk(torch.cat(pools_v, 1), torch.cat(pools_i, 1),
                              k)
    stages.mark("rerank")
    return out


def two_stage_topk(query_emb, matrix_or_gather, index: CentroidIndex,
                   k: int, *, nprobe: Union[int, str, None] = None,
                   inv_tau: float = 1.0, block_rows: Optional[int] = None):
    """Coarse-prune + exact-rerank top-k on the index's device.

    query_emb: (b, d), numpy or a tensor. matrix_or_gather: the (n, d)
    matrix on the index's device, or a ``gather(ids) -> (len(ids), d)``
    callback (ids: host int32, ascending; called once a rerank chunk) for
    galleries that stream blocks. nprobe: blocks probed per query; ``None`` / ``"all"`` / ``>=
    n_blocks`` is the exact case (the fused sweep's answer). Returns
    (values (b, k) fp32, indices (b, k) int32 global ids, both on the
    index's device, info) where info carries the prune telemetry:
    ``n_candidates``, ``n_blocks_probed``, ``prune_ratio`` (candidates /
    n, 1.0 = no prune), and per-stage seconds (``coarse_s``, ``gather_s``,
    ``rerank_s``; on the device's clock, the coarse stage's host prune
    included; the call returns once the rerank has finished)."""
    dev = index.device
    q = _rows(query_emb, dev)
    n = index.n
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, n={n}]")
    if nprobe is None or nprobe == "all":
        nprobe = index.n_blocks
    nprobe = int(nprobe)
    if nprobe < 1:
        raise ValueError(f"nprobe={nprobe} must be >= 1 (or 'all')")

    stages = _Stages(dev)
    if nprobe >= index.n_blocks:        # every block survives
        survivors = np.arange(index.n_blocks)
    else:
        scores = (q @ index.centroids.T).cpu().numpy()     # (b, P) coarse
        survivors = _survivor_blocks(index, scores, nprobe, k)
    stages.mark("coarse")

    full = len(survivors) == index.n_blocks
    if full and not callable(matrix_or_gather):     # no copy, one sweep
        n_cand = n
        stages.mark("gather")
        vals, gidx = topk_ops.similarity_topk(
            q.to(matrix_or_gather.dtype), matrix_or_gather, k,
            inv_tau=inv_tau, block_rows=block_rows)
        stages.mark("rerank")
    else:
        if full:
            cand_ids = torch.arange(n, dtype=torch.int32, device=dev)
        else:
            picked = index.members[torch.as_tensor(survivors, device=dev)]
            cand_ids = torch.sort(picked[picked >= 0]).values
        n_cand = len(cand_ids)
        stages.mark("gather")
        vals, gidx = _rerank(q, matrix_or_gather, cand_ids, min(k, n_cand),
                             stages, inv_tau=inv_tau, block_rows=block_rows)
    secs = stages.seconds()

    info = {"n_candidates": int(n_cand),
            "n_blocks_probed": int(len(survivors)),
            "prune_ratio": float(n_cand / n),
            **{f"{stage}_s": secs[stage] for stage in (
                "coarse", "gather", "rerank")}}
    return vals, gidx, info
