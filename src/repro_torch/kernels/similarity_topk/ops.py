"""Fused similarity→top-k over a class-embedding matrix: the wrapper of
``csrc/topk.cu``.

``similarity_topk(image_emb, class_emb, k)`` returns the top-k ``(values,
indices)`` of ``image_emb @ class_emb.T * inv_tau`` per row, descending,
ties to the lower class id, as the reference's ``topk_fused`` +
``ops.similarity_topk`` do (``repro/kernels/similarity_topk/kernel.py:85``).
``n_valid`` is the reference's runtime mask: classes at or past it score
``NEG`` under their own ids (the sharded path masks each shard's padded
tail with it), so with fewer than k valid classes the tail of a row is
``(NEG, masked id)``, ahead of the empty slots' ``(NEG, IDX_PAD)``.

On the card the class axis is split across CTAs: serving batches are at
most 64 rows, so one CTA per row block (the TPU's grid) would occupy one
SM of 132. Each CTA keeps a (b, k) partial top-k of its class range with
global ids, and the partials merge under the ``merge_topk`` rule inside
the same launch, in a tree of two levels: the last CTA of each group of
``MERGE_GROUP`` to finish merges its group, the last group merges the
groups. The rule does not depend on the order of the pool, so neither the
split nor the order of arrival can change the result. ``topk_plan`` sizes
the launch; the wrapper caches the plan per shape and (``StreamScratch``)
a zeroed counter and partial scratch per device and stream, so a call
allocates only its two outputs. On a CPU tensor the plain version in
``ref.py`` runs instead; on a CUDA tensor the kernel launches or it
raises; on a ``meta`` (or fake) tensor nothing launches: the wrapper
returns the two outputs' shapes and records the kernel's work
(``kernels.build.record_work``).
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.build import (KernelLibrary, LaunchCounter,
                                      StreamScratch, check, device_scope,
                                      is_abstract, record_work)
from repro_torch.kernels.similarity_topk.ref import NEG, similarity_topk_ref
from repro_torch.kernels.work import topk_work

MAX_K = 64           # the kernel keeps a running top-k of at most 64 slots
IDX_PAD = 2 ** 30    # sentinel index: above any real class id

CLASS_TILE = 128     # classes per tile in the kernel (csrc kBN)
CLASS_ALIGN = 16     # a CTA's class range is a multiple of this (one lane)
DEPTH_CHUNK = 32     # embedding depth per staged chunk (csrc kKC)
BLOCK_ROWS = (16, 64)  # image rows per CTA the kernel is built for
MAX_PARTIALS = 256   # partials per row at most (16 groups of 16)
MERGE_GROUP = 16     # partials a first-level merge takes (csrc kGroup)
SMEM_MAX = 230400    # dynamic shared memory per CTA (csrc kSmemMax)
SM_SMEM = 233472     # shared memory of one SM (228 KB)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary(
    "topk",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "topk.cu"),
    {"repro_similarity_topk": (_I, [_P, _P] + [_I] * 6 + [ctypes.c_float]
                               + [_I] * 4 + [_P] * 8)})
COUNTER = LaunchCounter("similarity_topk")
SCRATCH = StreamScratch()


def warps(rows: int) -> int:
    """Warps per CTA for ``rows`` image rows per CTA (csrc TopkLayout)."""
    return 8 if rows == 64 else 4


def smem_bytes(rows: int, d: int, k: int, itemsize: int,
               merge_buffers: int = 1) -> int:
    """Dynamic shared memory of one CTA, as csrc ``TopkLayout::bytes``
    counts it: the image block, the class ring, the lists and the half
    warps' runs while it computes; a merge's buffers of two rows'
    ``MERGE_GROUP`` partials per warp (which reuse them) at its end."""
    pad = 16 // itemsize
    xld = -(-d // DEPTH_CHUNK) * DEPTH_CHUNK + pad
    stages = 4 if rows == 16 else 3
    compute = (rows * xld * itemsize
               + stages * CLASS_TILE * (DEPTH_CHUNK + pad) * itemsize
               + rows * k * 8 + warps(rows) * 2 * k * 8)
    merge = warps(rows) * merge_buffers * 4 * MERGE_GROUP * k * 4
    return max(compute, merge)


def row_block(b: int, d: int = 512, k: int = 5, itemsize: int = 4) -> int:
    """Rows per CTA: 16 for the smallest batches, else 64 where a 64-row
    image block fits in shared memory beside the ring (d up to ~700 in
    f32), else 16."""
    if b <= 16 or smem_bytes(64, d, k, itemsize) > SMEM_MAX:
        return 16
    return 64


class TopkPlan(NamedTuple):
    """How ``similarity_topk`` launches: ``rows`` image rows per CTA and
    ``row_blocks`` of them, ``chunk`` classes per CTA and ``parts`` CTAs
    along the class axis (the partials each row's merge takes, in
    ``groups`` of ``MERGE_GROUP``), the merges' row buffers per warp (2:
    the next rows load while two merge), the CTA's dynamic shared memory,
    and the floats per row of the partials' (``stride``, parts · k rounded
    up to 4) and the group partials' (``group_stride``) scratch; the
    kernel counts finished CTAs in ``groups`` + 1 counters per row
    block."""
    rows: int
    row_blocks: int
    chunk: int
    parts: int
    groups: int
    merge_buffers: int
    smem: int
    stride: int
    group_stride: int


def topk_plan(b: int, n: int, d: int, k: int, itemsize: int, sms: int,
              block_rows: Optional[int] = None) -> TopkPlan:
    """The launch plan for b image rows against n classes of width d, top
    k, inputs of ``itemsize`` bytes, on a card of ``sms`` SMs.

    The class axis splits into ranges of a multiple of ``CLASS_ALIGN``
    classes, as many as fill the card once over all row blocks (the CTAs
    an SM holds follow from the shared memory), at most ``MAX_PARTIALS``."""
    rows = block_rows or row_block(b, d, k, itemsize)
    compute = smem_bytes(rows, d, k, itemsize)
    if compute > SMEM_MAX:
        raise ValueError(f"similarity_topk kernel: {rows} image rows of "
                         f"width {d} do not fit in shared memory")
    row_blocks = -(-b // rows)
    per_sm = max(1, min(2048 // (32 * warps(rows)),
                        SM_SMEM // (compute + 1024)))
    want = max(1, min(sms * per_sm // row_blocks, MAX_PARTIALS))
    chunk = -(-max(-(-n // want), CLASS_ALIGN) // CLASS_ALIGN) * CLASS_ALIGN
    parts = -(-n // chunk)
    groups = -(-parts // MERGE_GROUP)
    nb = 2 if smem_bytes(rows, d, k, itemsize, 2) <= compute else 1
    return TopkPlan(rows, row_blocks, chunk, parts, groups, nb,
                    smem_bytes(rows, d, k, itemsize, nb),
                    -(-parts * k // 4) * 4, -(-groups * k // 4) * 4)


_SMS = {}
_PLANS = {}


def _plan(b, n, d, k, itemsize, device, block_rows) -> TopkPlan:
    """``topk_plan`` on ``device``'s card, cached per shape."""
    key = (b, n, d, k, itemsize, device, block_rows)
    plan = _PLANS.get(key)
    if plan is None:
        if device not in _SMS:
            _SMS[device] = torch.cuda.get_device_properties(
                device).multi_processor_count
        plan = _PLANS[key] = topk_plan(b, n, d, k, itemsize, _SMS[device],
                                       block_rows)
    return plan


def merge_topk(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int):
    """Top-k of a (b, m) candidate pool: k select-max-retire rounds,
    descending by value, ties to the lower index (each round takes the
    smallest index among the columns at the row max, then retires it).
    Because the rule does not depend on the pool's order, merging per-chunk
    top-ks gives the same answer as one global sweep.

    cand_v: (b, m) fp32; cand_i: (b, m) int32 ids, unique per row
    (``IDX_PAD`` marks empty slots, which carry ``NEG``). Returns (values
    (b, k) fp32, indices (b, k) int32)."""
    if cand_v.shape[1] < k:
        raise ValueError(f"candidate pool {tuple(cand_v.shape)} narrower "
                         f"than k={k}")
    pad = torch.full_like(cand_i, IDX_PAD)
    neg = torch.full_like(cand_v, NEG)
    out_v, out_i = [], []
    for _ in range(int(k)):
        m = torch.amax(cand_v, dim=1)
        sel = torch.amin(torch.where(cand_v == m[:, None], cand_i, pad),
                         dim=1)
        out_v.append(m)
        out_i.append(sel)
        cand_v = torch.where(cand_i == sel[:, None], neg, cand_v)
    return (torch.stack(out_v, dim=1).float(),
            torch.stack(out_i, dim=1).to(torch.int32))


def similarity_topk(image_emb: torch.Tensor, class_emb: torch.Tensor, k: int,
                    *, inv_tau: float = 1.0,
                    block_rows: Optional[int] = None,
                    n_valid: Optional[int] = None):
    """Top-k similarities of each image row against every class row.

    image_emb: (b, d); class_emb: (n, d), f32 or bf16 (accumulated in
    fp32); 1 <= k <= min(n, MAX_K). Returns (values (b, k) fp32, indices
    (b, k) int32), rows sorted descending, ties broken by the lower class
    id. ``n_valid`` (an int in [0, n]; None means n): classes at or past
    it score ``NEG`` and keep their ids. ``block_rows`` (one of
    ``BLOCK_ROWS``) overrides the kernel's image rows per CTA, which
    ``row_block`` picks otherwise. One call launches one device kernel."""
    if image_emb.dim() != 2 or class_emb.dim() != 2:
        raise ValueError("expected image_emb (b, d) and class_emb (n, d)")
    b, d = image_emb.shape
    n, d2 = class_emb.shape
    if d != d2:
        raise ValueError(f"embed dims differ: image {d} vs class {d2}")
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, n_classes={n}]")
    if k > MAX_K:
        raise ValueError(f"k={k} > MAX_K={MAX_K}")
    if block_rows is not None and block_rows not in BLOCK_ROWS:
        raise ValueError(f"block_rows={block_rows} not in {BLOCK_ROWS}")
    n_valid = n if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} must be in [0, n={n}]")
    abstract = is_abstract(image_emb)
    if image_emb.device.type == "cpu" and not abstract:
        return similarity_topk_ref(image_emb, class_emb, k, inv_tau,
                                   n_valid)
    if image_emb.device.type != "cuda" and not abstract:
        raise ValueError(f"similarity_topk runs on cpu or cuda, not "
                         f"{image_emb.device}")
    if class_emb.device != image_emb.device:
        raise ValueError("image_emb and class_emb must be on one device")
    if image_emb.dtype not in _DTYPES or class_emb.dtype != image_emb.dtype:
        raise TypeError(f"similarity_topk kernel takes f32 or bf16 inputs "
                        f"of one dtype, got {image_emb.dtype}/"
                        f"{class_emb.dtype}")
    if not (image_emb.is_contiguous() and class_emb.is_contiguous()):
        raise ValueError("similarity_topk kernel needs contiguous inputs")
    dev = image_emb.device

    def work():
        return topk_work(b, n, d, k, image_emb.element_size(), n_valid)
    if abstract:
        record_work(COUNTER.name, work)
        return (torch.empty((b, k), dtype=torch.float32, device=dev),
                torch.empty((b, k), dtype=torch.int32, device=dev))
    plan = _plan(b, n, d, k, image_emb.element_size(), dev, block_rows)
    stream = torch.cuda.current_stream(dev)
    per_row = plan.stride + plan.group_stride
    buf, counters = SCRATCH.get(stream, 2 * b * per_row,
                                plan.row_blocks * (plan.groups + 1))
    # fp32 values then int32 ids: partials (b, stride), groups (b,
    # group_stride)
    part_v = buf.data_ptr()
    part_i = part_v + 4 * b * per_row
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    with device_scope(dev):
        rc = LIB.lib().repro_similarity_topk(
            image_emb.data_ptr(), class_emb.data_ptr(),
            _DTYPES[image_emb.dtype], b, n, d, k, n_valid, float(inv_tau),
            plan.rows, plan.chunk, plan.parts, plan.merge_buffers, part_v,
            part_i, part_v + 4 * b * plan.stride,
            part_i + 4 * b * plan.stride,
            counters.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            stream.cuda_stream)
    if rc != 0:
        SCRATCH.drop(stream)
    check(rc, "similarity_topk launch")
    COUNTER.add()
    record_work(COUNTER.name, work)
    return vals, idx


def classify(image_emb: torch.Tensor, class_emb: torch.Tensor, *,
             inv_tau: float = 1.0) -> torch.Tensor:
    """Top-1 class id per row, (b,) int32."""
    _, idx = similarity_topk(image_emb, class_emb, 1, inv_tau=inv_tau)
    return idx[:, 0]
