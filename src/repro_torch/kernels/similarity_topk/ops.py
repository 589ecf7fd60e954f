"""Fused similarity→top-k over a class-embedding matrix: the wrapper of
``csrc/topk.cu``.

``similarity_topk(image_emb, class_emb, k)`` returns the top-k ``(values,
indices)`` of ``image_emb @ class_emb.T * inv_tau`` per row, descending,
ties to the lower class id, as the reference's ``topk_fused`` +
``ops.similarity_topk`` do (``repro/kernels/similarity_topk/kernel.py:85``).

On the card the class axis is split across CTAs: serving batches are at
most 64 rows, so one CTA per row block (the TPU's grid) would occupy one
SM of 132. Each CTA writes a (b, k) partial top-k of its class chunk with
global ids, and a second kernel merges the partials under the
``merge_topk`` rule, which does not depend on the order of the pool, so the
split cannot change the result. On a CPU tensor the plain version in
``ref.py`` runs instead; on a CUDA tensor the kernels launch or it raises.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from repro_torch.kernels.build import KernelLibrary, LaunchCounter, check
from repro_torch.kernels.similarity_topk.ref import similarity_topk_ref

MAX_K = 64           # the kernel keeps a running top-k of at most 64 slots
NEG = -1e30          # sentinel value: below any real similarity
IDX_PAD = 2 ** 30    # sentinel index: above any real class id

CLASS_TILE = 64      # classes per staged tile in the kernel (csrc kBC)
BLOCK_ROWS = (16, 64)  # image rows per CTA the kernel is built for
MAX_PARTIALS = 1024  # the merge kernel runs one thread per partial
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary(
    "topk",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "topk.cu"),
    {"repro_similarity_topk": (_I, [_P, _P, _I, _I, _I, _I, _I,
                                    ctypes.c_float, _I, _I, _I, _P, _P, _P,
                                    _P, _P])})
COUNTER = LaunchCounter("similarity_topk")


def row_block(b: int) -> int:
    """Rows per CTA: 16 for the smallest batches, else 64."""
    return 16 if b <= 16 else 64


def class_chunks(n: int, b: int, sm_count: int, rows: int) -> tuple:
    """Split of the class axis for ``rows`` image rows per CTA: (classes per
    CTA, number of partials), about two CTAs per SM over all row blocks,
    chunks a multiple of the tile."""
    row_blocks = -(-b // rows)
    target = max(1, -(-2 * sm_count // row_blocks))
    chunk = max(-(-n // target), -(-n // MAX_PARTIALS))
    chunk = -(-chunk // CLASS_TILE) * CLASS_TILE
    return chunk, -(-n // chunk)


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
                    block_rows: Optional[int] = None):
    """Top-k similarities of each image row against every class row.

    image_emb: (b, d); class_emb: (n, d), f32 or bf16 (accumulated in
    fp32); 1 <= k <= min(n, MAX_K). Returns (values (b, k) fp32, indices
    (b, k) int32), rows sorted descending, ties broken by the lower class
    id. ``block_rows`` (one of ``BLOCK_ROWS``) overrides the kernel's image
    rows per CTA, which ``row_block(b)`` picks otherwise."""
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
    if image_emb.device.type == "cpu":
        return similarity_topk_ref(image_emb, class_emb, k, inv_tau)
    if image_emb.device.type != "cuda":
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = block_rows or row_block(b)
    chunk, parts = class_chunks(n, b, sms, rows)
    part_v = torch.empty((b, parts, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, parts, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = LIB.lib().repro_similarity_topk(
            image_emb.data_ptr(), class_emb.data_ptr(),
            _DTYPES[image_emb.dtype], b, n, d, k, float(inv_tau), rows,
            chunk, parts, part_v.data_ptr(), part_i.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), stream)
    check(rc, "similarity_topk launch")
    COUNTER.add()
    return vals, idx


def classify(image_emb: torch.Tensor, class_emb: torch.Tensor, *,
             inv_tau: float = 1.0) -> torch.Tensor:
    """Top-1 class id per row, (b,) int32."""
    _, idx = similarity_topk(image_emb, class_emb, 1, inv_tau=inv_tau)
    return idx[:, 0]
