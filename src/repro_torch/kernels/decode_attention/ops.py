"""Single-token GQA decode attention: the wrapper of ``csrc/decode.cu``.

``decode_attention(q, k, v, valid)`` computes what the reference's
``decode_attention_bkv`` + ``ops.decode_attention`` compute
(``repro/kernels/decode_attention/kernel.py:72``): every query head
attends over its kv head's cache under a validity mask, shared by every
row (``(t,)``, the lockstep engine) or one per slot (``(b, t)``, the
continuous engine), and a row with no valid key returns exact zeros.

The (b, h, d) queries and (b, kv, t, d) cache go to the kernel as views,
(b·kv, g, d) and (b·kv, t, d): valid because the h = kv·g query heads are
laid out kv-major, as the reference relies on
(``repro/kernels/decode_attention/ops.py:21-23``). A layer's slice of the
stacked cache is contiguous, so nothing is copied; a non-contiguous cache
raises instead, since a copy at the serving shape moves the whole cache.
A (b, t) mask reaches the kernel once per slot and is read as row
``r / kv``, in place of the reference's ``jnp.repeat``.

The kernel splits each row's sweep into chunks of ``chunk_len(t)`` keys,
a function of t alone, and a second kernel merges the chunks in order.
``decode_plan`` sizes the rest of the launch: the query heads a CTA takes
(4, 8 or 16), and how many CTAs share a row's chunks so that the grid
fills the card once. A CTA skips every chunk and 16-key unit that the mask
kills. With ``return_lse`` the merge kernel also writes each row's
log-sum-exp, which a rank holding a slice of a cache's sequence merges
its partial through (``models.attention.merge_partials``). On a CPU
tensor the plain version in ``ref.py`` runs instead; on a CUDA tensor the
kernels launch or it raises. On a ``meta`` (or fake) tensor nothing
launches: the wrapper returns the outputs' shapes and records the
kernel's work over the whole cache
(``kernels.build.record_work``; the per-stream scratch it keeps between
calls is not a call's allocation).
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from repro_torch.kernels.build import (KernelLibrary, LaunchCounter,
                                      StreamScratch, check, device_scope,
                                      is_abstract, misaligned, record_work)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.work import decode_work

HEAD_DIMS = (64, 128)
UNIT = 16            # keys per warp step in the kernel (csrc kUnit)
CHUNK_ALIGN = 128    # chunk lengths are a multiple of this (csrc)
MIN_CHUNK = 256      # keys per chunk at least
MAX_CHUNKS = 64      # chunks per row at most (csrc kMaxChunks)
MAX_CTA_KEYS = 8192  # keys one CTA may hold validity bits for (csrc)
GROUPS = (4, 8, 16)  # query heads per CTA the kernel is built for
MAX_T = MAX_CHUNKS * MAX_CTA_KEYS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary(
    "decode_attention",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "decode.cu"),
    {"repro_decode_attention": (_I, [_P] * 7 + [_I] * 10
                                + [ctypes.c_float, _P]),
     "repro_decode_blocks_per_sm": (_I, [_I, _I, _I,
                                         ctypes.POINTER(ctypes.c_int)])})
COUNTER = LaunchCounter("decode_attention")
SCRATCH = StreamScratch()


def chunk_len(t: int) -> int:
    """Keys per chunk of the split sweep, from the cache length alone: at
    least ``MIN_CHUNK``, at most ``MAX_CHUNKS`` chunks, a multiple of
    ``CHUNK_ALIGN``."""
    c = max(MIN_CHUNK, -(-t // MAX_CHUNKS))
    return -(-c // CHUNK_ALIGN) * CHUNK_ALIGN


def head_group(g: int) -> int:
    """Query heads per CTA for a GQA group of ``g``: the smallest of
    ``GROUPS`` that holds it, else the largest (several CTAs per row)."""
    return next((gp for gp in GROUPS if g <= gp), GROUPS[-1])


class DecodePlan(NamedTuple):
    """How ``decode_attention`` launches: ``chunk_len`` keys per chunk and
    ``n_chunks`` chunks per row (from t alone), ``group`` query heads per
    CTA, ``ctas_per_row`` CTAs sharing a row's chunks (CTA y takes chunks
    y, y + C, ...), the split kernel's ``grid`` (rows, ctas_per_row, head
    groups) and the fp32 partials' size (m and l per chunk and head, then
    acc of d values)."""
    chunk_len: int
    n_chunks: int
    group: int
    ctas_per_row: int
    grid: tuple
    scratch_floats: int


def decode_plan(b: int, kv: int, g: int, t: int, d: int, sms: int,
                blocks_per_sm: int) -> DecodePlan:
    """The launch plan for ``b`` slots of ``kv`` heads, ``g`` query heads
    each, over a cache of ``t`` keys of width ``d``, on a card of ``sms``
    SMs holding ``blocks_per_sm`` split-kernel CTAs each.

    The CTAs per row are the most that still fit the card in one wave
    (at least one), then as few as keep the largest number of chunks per
    CTA, so that every CTA sweeps about as much; a CTA holds validity bits
    for at most ``MAX_CTA_KEYS`` keys. None of it changes a result: a
    chunk's partial is the same whichever CTA computes it."""
    if not 1 <= t <= MAX_T:
        raise ValueError(f"decode_attention kernel takes 1 <= t <= {MAX_T},"
                         f" got {t}")
    cl = chunk_len(t)
    n = -(-t // cl)
    group = head_group(g)
    groups = -(-g // group)
    rows = b * kv
    per_row = max(1, (sms * blocks_per_sm) // (rows * groups))
    ctas = min(n, max(per_row, -(-n // (MAX_CTA_KEYS // cl))))
    ctas = -(-n // -(-n // ctas))
    return DecodePlan(cl, n, group, ctas, (rows, ctas, groups),
                      rows * g * n * (d + 2))


_SMS = {}
_BLOCKS = {}
_PLANS = {}


def _card(device: torch.device, dtype_code: int, d: int, group: int):
    """(SMs of the card, resident split-kernel CTAs per SM), cached."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    key = (idx, dtype_code, d, group)
    if key not in _BLOCKS:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            check(LIB.lib().repro_decode_blocks_per_sm(dtype_code, d, group,
                                                       ctypes.byref(out)),
                  "decode_attention occupancy")
        _BLOCKS[key] = max(1, out.value)
    return _SMS[idx], _BLOCKS[key]


def launch_plan(q: torch.Tensor, k: torch.Tensor) -> DecodePlan:
    """The plan a call with CUDA q (b, h, d) and cache k (b, kv, t, d)
    launches with, on q's card (cached per shape)."""
    key = (q.shape, k.shape, q.dtype, q.device)
    plan = _PLANS.get(key)
    if plan is None:
        b, h, d = q.shape
        kv, t = k.shape[1], k.shape[2]
        g = h // kv
        sms, blocks = _card(q.device, _DTYPES[q.dtype], d, head_group(g))
        plan = _PLANS[key] = decode_plan(b, kv, g, t, d, sms, blocks)
    return plan


def _check_inputs(q, k, v, valid):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (b, h, d), k/v (b, kv, t, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    kb, kv, t, dk = k.shape
    if kb != b or dk != d or kv == 0 or h % kv != 0 or t == 0:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k.shape)} (h a multiple of kv, t >= 1)")
    if valid.dtype != torch.bool or valid.shape not in ((t,), (b, t)):
        raise ValueError(f"valid must be bool ({t},) or ({b}, {t}), got "
                         f"{valid.dtype} {tuple(valid.shape)}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, return_lse: bool = False):
    """q: (b, h, d); k/v: (b, kv, t, d); valid: (t,) bool shared by every
    row, or (b, t) bool per slot. Returns (b, h, d) in q's dtype; rows
    with no valid key are zeros. With ``return_lse`` returns (out, lse):
    lse (b, h) fp32, each row's log-sum-exp of its scaled valid scores
    (q·k·d^-1/2), -1e30 where it has none.

    The kernel takes f32 or bf16 q and cache of one dtype, head dims 64
    and 128, any GQA group and 1 <= t <= ``MAX_T``, with contiguous q and
    cache. One call launches two device kernels (split and merge), with
    or without the lse."""
    _check_inputs(q, k, v, valid)
    abstract = is_abstract(q)
    if q.device.type == "cpu" and not abstract:
        return decode_attention_ref(q, k, v, valid, return_lse)
    if q.device.type != "cuda" and not abstract:
        raise ValueError(f"decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    b, h, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes f32 or bf16 q and "
                        f"cache of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel supports head dims "
                         f"{HEAD_DIMS}, got {d}")
    if any(x.device != q.device for x in (k, v, valid)):
        raise ValueError("q, the cache and valid must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention kernel needs contiguous q and "
                         "cache (a copy would move the whole cache)")
    if any(misaligned(x) for x in (q, k, v)):
        raise ValueError("decode_attention kernel needs 16-byte aligned q "
                         "and cache")

    def work():
        # the kernel skips masked chunks: the mask's count is on the
        # device, so the whole cache is recorded (an upper bound)
        return decode_work(b, h, kv, t, d, q.element_size(),
                           lse=return_lse)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if abstract:
        record_work(COUNTER.name, work)
        return (out, lse) if return_lse else out
    g = h // kv
    valid = valid.contiguous()
    plan = launch_plan(q, k)
    stream = torch.cuda.current_stream(q.device)
    part, _ = SCRATCH.get(stream, plan.scratch_floats, 0)
    with device_scope(q.device):
        rc = LIB.lib().repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            part.data_ptr(), _DTYPES[q.dtype], b * kv, g, t, d,
            kv if valid.dim() == 2 else 0, plan.chunk_len, plan.n_chunks,
            plan.ctas_per_row, plan.group, float(d ** -0.5),
            stream.cuda_stream)
    check(rc, "decode_attention launch")
    COUNTER.add(shape=(b, h, kv, t, d))
    record_work(COUNTER.name, work)
    return (out, lse) if return_lse else out
