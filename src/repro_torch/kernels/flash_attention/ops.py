"""Flash attention: the wrappers of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, and the differentiable op built on them.

``flash_fwd`` computes what the reference's ``flash_fwd_bh`` computes
(``repro/kernels/flash_attention/kernel.py:97``): online-softmax attention
over flattened heads, with causal, sliding-window or bidirectional masks and
an optional additive key bias, returning ``out`` and the per-row ``lse``.
``flash_bwd`` computes what ``flash_bwd_bh`` computes (``kernel.py:230``):
dq, dk, dv recomputed blockwise from ``lse``, with dk and dv summed over
the query heads of each grouped-query kv head.
``flash_attention`` is the (b, h, s, d) entry the towers' ``flash`` backend
calls, differentiable through a ``torch.autograd.Function`` that mirrors the
reference's custom VJP (``repro/kernels/flash_attention/ops.py:43-67``):
the forward kernel saves (q, k, v, bias, out, lse) and the backward kernel
consumes them. Grouped-query heads map to their kv head inside both
kernels, and a (b, t) key-padding mask rides in as one bias row per example;
the bias is a constant of the computation (its gradient is None).

On a CPU tensor the wrappers run the plain versions in ``ref.py``; on a
CUDA tensor they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from repro_torch.kernels.build import KernelLibrary, LaunchCounter, check
from repro_torch.kernels.flash_attention.ref import (NEG_INF, flash_bwd_ref,
                                                     flash_fwd_ref)

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
LIB = KernelLibrary(
    "flash_fwd", os.path.join(_CSRC, "flash_fwd.cu"),
    {"repro_flash_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, ctypes.c_float, _P])})
COUNTER = LaunchCounter("flash_fwd")
BWD_LIB = KernelLibrary(
    "flash_bwd", os.path.join(_CSRC, "flash_bwd.cu"),
    {"repro_flash_bwd": (_I, [_P] * 11 + [_I] * 9 + [ctypes.c_float, _P])})
BWD_COUNTER = LaunchCounter("flash_bwd")


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


def _check_kernel_inputs(what, q, k, v, bias, *rest):
    """What both kernels take: f32 or bf16 q/k/v of one dtype, head dims
    64 and 128, contiguous tensors on one CUDA device, fp32 bias."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {q.device}")
    d = q.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} kernel supports head dims {HEAD_DIMS}, "
                         f"got {d}")
    tensors = [q, k, v, *rest] + ([bias] if bias is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v, bias and the saved tensors must be on "
                         "one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{what} kernel needs contiguous inputs")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")


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
    _check_kernel_inputs("flash_fwd", q, k, v, bias)
    bh, s, d = q.shape
    t = k.shape[1]
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


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], out: torch.Tensor,
              lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None):
    """Layouts as ``flash_fwd``, plus its out (bh, s, d) and lse (bh, s)
    fp32 and the upstream gradient dout (bh, s, d) in q's dtype. Returns
    (dq, dk, dv) in the input dtype: dq (bh, s, d), dk/dv (bh // group,
    t, d) summed over each group's query heads. One call launches three
    device kernels (delta, dq, dk/dv)."""
    _check_inputs(q, k, v, bias)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != q.shape[:2]:
        raise ValueError(f"out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, bias, out, lse, dout, causal=causal,
                             window=window)
    _check_kernel_inputs("flash_bwd", q, k, v, bias, out, lse, dout)
    if out.dtype != q.dtype or dout.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise TypeError(f"flash_bwd takes out/dout in q's dtype and fp32 "
                        f"lse, got {out.dtype}/{dout.dtype}/{lse.dtype}")
    bh, s, d = q.shape
    t = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = BWD_LIB.lib().repro_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype],
            bh, s, t, d, bh // k.shape[0],
            bh // bias.shape[0] if bias is not None else 1, int(causal),
            window if window is not None else -1, float(d ** -0.5), stream)
    check(rc, "flash_bwd launch")
    BWD_COUNTER.add()
    return dq, dk, dv


class _FlashBH(torch.autograd.Function):
    """Flattened-head flash attention with the kernels' backward (the
    reference's ``_flash_bh`` custom VJP). The residuals are (q, k, v,
    bias, out, lse); the key bias is a constant (gradient None)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, window):
        out, lse = flash_fwd(q, k, v, bias, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, bias, out, lse,
                               dout.to(q.dtype).contiguous(),
                               causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


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
    >= 1 valid key). Returns (b, h, s, d) in q's dtype, differentiable in
    q, k and v through the backward kernel."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if h % kv != 0:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    bias = None
    if key_mask is not None:
        bias = key_bias(key_mask).reshape(b, t).contiguous()
    out = _FlashBH.apply(q.reshape(b * h, s, d).contiguous(),
                         k.reshape(b * kv, t, d).contiguous(),
                         v.reshape(b * kv, t, d).contiguous(), bias, causal,
                         window)
    return out.reshape(b, h, s, d)
