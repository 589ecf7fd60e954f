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
On a CPU tensor the plain version in ``ref.py`` runs instead; on a CUDA
tensor the kernels launch or it raises.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels.build import KernelLibrary, LaunchCounter, check
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (64, 128)
TILE = 128           # keys per staged tile in the kernel (csrc kTK)
MIN_CHUNK = 256      # keys per chunk at least
MAX_CHUNKS = 64      # chunks per row at most
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary(
    "decode_attention",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "decode.cu"),
    {"repro_decode_attention": (_I, [_P] * 8 + [_I] * 8
                                + [ctypes.c_float, _P])})
COUNTER = LaunchCounter("decode_attention")


def chunk_len(t: int) -> int:
    """Keys per chunk of the split sweep, from the cache length alone: at
    least ``MIN_CHUNK``, at most ``MAX_CHUNKS`` chunks, a multiple of the
    tile."""
    c = max(MIN_CHUNK, -(-t // MAX_CHUNKS))
    return -(-c // TILE) * TILE


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
                     valid: torch.Tensor) -> torch.Tensor:
    """q: (b, h, d); k/v: (b, kv, t, d); valid: (t,) bool shared by every
    row, or (b, t) bool per slot. Returns (b, h, d) in q's dtype; rows
    with no valid key are zeros.

    The kernel takes f32 or bf16 q and cache of one dtype, head dims 64
    and 128, any GQA group and any t >= 1, with contiguous q and cache.
    One call launches two device kernels (split and merge)."""
    _check_inputs(q, k, v, valid)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid)
    if q.device.type != "cuda":
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
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("decode_attention kernel needs 16-byte aligned q "
                         "and cache")
    g = h // kv
    valid = valid.contiguous()
    out = torch.empty_like(q)
    cl = chunk_len(t)
    n_chunks = -(-t // cl)
    part_m = torch.empty((b * kv, g, n_chunks), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b * kv, g, n_chunks, d), dtype=torch.float32,
                           device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = LIB.lib().repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), _DTYPES[q.dtype], b * kv, g, t, d,
            kv if valid.dim() == 2 else 0, cl, n_chunks, float(d ** -0.5),
            stream)
    check(rc, "decode_attention launch")
    COUNTER.add()
    return out
