"""Flash-attention forward: the wrapper of ``csrc/flash_fwd.cu``.

``flash_fwd`` computes what the reference's ``flash_fwd_bh`` computes
(``repro/kernels/flash_attention/kernel.py:97``): online-softmax attention
over flattened heads, with causal, sliding-window or bidirectional masks and
an optional additive key bias, returning ``out`` and the per-row ``lse``.
``flash_attention`` is the (b, h, s, d) entry the towers' ``flash`` backend
calls: grouped-query heads map to their kv head inside the kernel, and a
(b, t) key-padding mask rides in as one bias row per example.

On a CPU tensor the wrappers run the plain version in ``ref.py``; on a CUDA
tensor they launch the kernel or raise. Forward only: the backward kernels
come with the training slice of the port.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from repro_torch.kernels.build import KernelLibrary, LaunchCounter, check
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_fwd_ref

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary(
    "flash_fwd",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "flash_fwd.cu"),
    {"repro_flash_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, ctypes.c_float, _P])})
COUNTER = LaunchCounter("flash_fwd")


def _check_inputs(q, k, v, bias):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected q (bh, s, d), k/v (bkv, t, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, d = q.shape
    bkv, t, dk = k.shape
    if v.shape != k.shape or dk != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if bkv == 0 or bh % bkv != 0 or s == 0 or t == 0:
        raise ValueError(f"bh={bh} must be a multiple of the kv rows "
                         f"{bkv}, with s={s}, t={t} >= 1")
    if bias is not None and (bias.dim() != 2 or bias.shape[1] != t
                             or bias.shape[0] == 0
                             or bh % bias.shape[0] != 0):
        raise ValueError(f"bias {tuple(bias.shape)} must be (rows, {t}) "
                         f"with bh={bh} a multiple of rows")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, causal: bool = True,
              window: Optional[int] = None):
    """q: (bh, s, d); k/v: (bh // group, t, d), query row ``i`` reading kv
    row ``i // group``; bias: optional (bh // heads, t) fp32 additive key
    bias. Returns (out (bh, s, d) in q's dtype, lse (bh, s) fp32).

    Every query row must keep at least one valid key. The kernel takes
    f32 or bf16 inputs (accumulating fp32), head dims 64 and 128, and any
    s, t >= 1 (the ragged tail is masked, never written)."""
    _check_inputs(q, k, v, bias)
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, bias, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cpu or cuda, not {q.device}")
    bh, s, d = q.shape
    t = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd kernel takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel supports head dims {HEAD_DIMS}, "
                         f"got {d}")
    tensors = [q, k, v] + ([bias] if bias is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v and bias must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_fwd kernel needs contiguous inputs")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = LIB.lib().repro_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), lse.data_ptr(), _DTYPES[q.dtype], bh, s, t, d,
            bh // k.shape[0], bh // bias.shape[0] if bias is not None else 1,
            int(causal), window if window is not None else -1,
            float(d ** -0.5), stream)
    check(rc, "flash_fwd launch")
    COUNTER.add()
    return out, lse


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """(b, t) bool (True = attend) or additive mask -> (b, t) fp32 bias
    with the ``NEG_INF`` convention."""
    if key_mask.dtype == torch.bool:
        zero = torch.zeros((), dtype=torch.float32, device=key_mask.device)
        neg = torch.full((), NEG_INF, dtype=torch.float32,
                         device=key_mask.device)
        return torch.where(key_mask, zero, neg)
    return key_mask.float()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (b, h, s, d); k/v: (b, kv, t, d) with h % kv == 0; key_mask:
    optional (b, t) bool or additive mask on padded keys (every query keeps
    >= 1 valid key). Returns (b, h, s, d) in q's dtype."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if h % kv != 0:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    bias = None
    if key_mask is not None:
        bias = key_bias(key_mask).reshape(b, t).contiguous()
    out, _ = flash_fwd(q.reshape(b * h, s, d).contiguous(),
                       k.reshape(b * kv, t, d).contiguous(),
                       v.reshape(b * kv, t, d).contiguous(), bias,
                       causal=causal, window=window)
    return out.reshape(b, h, s, d)
