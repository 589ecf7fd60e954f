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
CUDA tensor they launch the kernels or raise. On a ``meta`` (or fake)
tensor they launch nothing: they allocate what the launch would and
record the kernel's work (``kernels.build.record_work``).
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.build import (KernelLibrary, LaunchCounter, check,
                                      device_scope, is_abstract, misaligned,
                                      record_work)
from repro_torch.kernels.flash_attention.ref import (NEG_INF, flash_bwd_ref,
                                                     flash_fwd_ref)
from repro_torch.kernels.work import flash_bwd_work, flash_fwd_work

HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
LIB = KernelLibrary(
    "flash_fwd", os.path.join(_CSRC, "flash_fwd.cu"),
    {"repro_flash_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, ctypes.c_float, _I, _I, _I,
                              _P])})
COUNTER = LaunchCounter("flash_fwd")
BWD_LIB = KernelLibrary(
    "flash_bwd", os.path.join(_CSRC, "flash_bwd.cu"),
    {"repro_flash_bwd": (_I, [_P] * 12 + [_I] * 11 + [ctypes.c_float, _P])})
BWD_COUNTER = LaunchCounter("flash_bwd")


# what one CTA may hold in shared memory on the H100 (227 KB). A plan's
# ``smem`` is what its launch allocates: the C entries take it and refuse
# bytes other than their own layout's for that plan.
SMEM_LIMIT = 232448
# the f32 backward's streamed q tile (rows)
_F32_BQ = 32


def _f32_bwd_smem(key_block: int, d: int) -> int:
    """The f32 backward's shared memory for ``key_block`` keys, fp32 rows
    of d + 4: k, v; two stages of q and dout; the lo halves of q and dout;
    dsᵀ as tf32 hi and lo planes; lse, delta and the bias."""
    ld = d + 4
    return 4 * (2 * key_block * ld + 6 * _F32_BQ * ld
                + 2 * key_block * (_F32_BQ + 4) + 4 * _F32_BQ + key_block)


# the f32 backward's key block at most: the most 16-key steps whose k, v
# and tiles fit one CTA (208 keys at d 64, 160 at d 80, 96 at d 128)
F32_MAX_KEY_BLOCK = {d: 16 * max(w for w in range(1, 64)
                                 if _f32_bwd_smem(16 * w, d) <= SMEM_LIMIT)
                     for d in HEAD_DIMS}
# the bf16 backward's key block past t = 64, by head dim (16 keys a warp)
_BF16_KEY_BLOCK = {64: 256, 80: 160, 128: 128}
# a CUDA grid's y extent at most: query blocks (forward), key blocks
# (backward)
MAX_GRID_Y = 65535


class FwdPlan(NamedTuple):
    """How ``flash_fwd`` launches: ``warps`` per CTA, each owning 16 query
    rows, ``key_tile`` keys per staged k/v tile, the grid (heads, query
    blocks) and the CTA's dynamic shared memory in bytes."""
    warps: int
    key_tile: int
    grid: tuple
    smem: int


def fwd_plan(bh: int, s: int, t: int, d: int, dtype: torch.dtype) -> FwdPlan:
    """The forward kernel's launch plan for q (bh, s, d) against t keys.

    Both dtypes run a tensor-core kernel with 16 query rows per warp: 4
    warps (64 rows) per CTA, fewer where s <= 48, so that no warp of a short
    row block idles (the text tower's s = 16 runs one warp per head). k/v
    arrive in tiles of 64 keys in bf16 and 32 in f32 (whose CTA also holds
    the tile split into tf32 pairs: at 32 keys three CTAs fit an SM), or of
    t rounded up to the kernel's key step (16 in bf16, 8 in f32) where t is
    shorter, so a short head stages no padding and its CTA holds little
    shared memory. ``d`` sizes the shared memory (the kernels take 64, 80
    and 128)."""
    warps = min(4, -(-s // 16))
    if dtype == torch.bfloat16:
        key_tile = min(64, -(-t // 16) * 16)
        stages = 2 if t > key_tile else 1
        smem = 2 * (d + 8) * (16 * warps + 2 * stages * key_tile)
    else:
        key_tile = min(32, -(-t // 8) * 8)
        stages = 2 if t > key_tile else 1
        # the raw k/v ring, then the tile's tf32 (hi, lo) pairs
        smem = (4 * (d + 4) * 2 * stages * key_tile
                + 8 * key_tile * (2 * d + 6))
    return FwdPlan(warps, key_tile, (bh, -(-s // (16 * warps))), smem)


class BwdPlan(NamedTuple):
    """How ``flash_bwd`` splits a call: ``key_block`` keys per CTA (16 per
    warp), ``key_blocks`` CTAs per kv row, the fp32 dq partials
    (``dq_part_floats`` entries) when there is more than one key block, and
    the main kernel's dynamic shared memory in bytes."""
    key_block: int
    key_blocks: int
    dq_part_floats: int
    smem: int


def bwd_plan(bh: int, s: int, t: int, d: int, dtype: torch.dtype) -> BwdPlan:
    """The backward kernel's launch plan for q (bh, s, d) against t keys.

    bf16 runs its tensor-core kernel with 16 keys per warp: 4 warps when
    t <= 64 (the text tower), else 16 warps at d 64, 10 at d 80 and 8 at
    d 128 (the registers of the dk and dv accumulators bound a warp's
    share; at d 80 the dq phase needs W / 2 to divide d's ten 8-wide
    n-tiles). A block of 256 keys at d 64 holds the whole head at the
    towers' lengths. f32 takes t rounded up to 16 keys while k, v, the
    q/dout ring with the tiles' split halves and the dsᵀ planes fit one
    CTA's shared memory: up to 208 keys at d 64 (the image tower's 196 in
    one block of 13 warps), 160 at d 80 and 96 at d 128. Past one block
    the keys split over ceil(t / key_block) CTAs, each writing an fp32 dq
    partial that a second kernel sums in block order."""
    if dtype == torch.bfloat16:
        key_block = 64 if t <= 64 else _BF16_KEY_BLOCK[d]
        ld = d + 8
        smem = (2 * (2 * key_block * ld + 4 * 32 * ld + key_block * 40)
                + 4 * (4 * 32 + key_block))
    else:
        key_block = min(-(-t // 16) * 16, F32_MAX_KEY_BLOCK[d])
        smem = _f32_bwd_smem(key_block, d)
    blocks = -(-t // key_block)
    return BwdPlan(key_block, blocks,
                   blocks * bh * s * d if blocks > 1 else 0, smem)


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
    64, 80 and 128, contiguous tensors on one CUDA device (or abstract
    ones), fp32 bias."""
    if q.device.type != "cuda" and not is_abstract(q):
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
    f32 (split 3×TF32 tensor cores) or bf16 (tensor cores) inputs, launched
    as ``fwd_plan`` says, accumulating fp32, head dims 64, 80 and 128, and
    any s, t >= 1 (the ragged tail is masked, never written) that the plan
    can grid (at most 65535 query blocks)."""
    _check_inputs(q, k, v, bias)
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if q.device.type == "cpu" and not is_abstract(q):
        return flash_fwd_ref(q, k, v, bias, causal=causal, window=window)
    _check_kernel_inputs("flash_fwd", q, k, v, bias)
    if any(misaligned(x) for x in (q, k, v)):
        raise ValueError("the flash_fwd kernel copies 16-byte rows: q, k "
                         "and v must start 16-byte aligned")
    bh, s, d = q.shape
    t = k.shape[1]
    plan = fwd_plan(bh, s, t, d, q.dtype)
    if plan.grid[1] > MAX_GRID_Y:
        raise ValueError(f"flash_fwd: s={s} needs {plan.grid[1]} query "
                         f"blocks of {16 * plan.warps} rows, more than the "
                         f"grid's {MAX_GRID_Y}")
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)

    def work():
        return flash_fwd_work(bh, k.shape[0], s, t, d, q.element_size(),
                              causal=causal, window=window,
                              bias_rows=0 if bias is None else bias.shape[0])
    if is_abstract(q):
        record_work(COUNTER.name, work)
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with device_scope(q.device):
        rc = LIB.lib().repro_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), lse.data_ptr(), _DTYPES[q.dtype], bh, s, t, d,
            bh // k.shape[0], bh // bias.shape[0] if bias is not None else 1,
            int(causal), window if window is not None else -1,
            float(d ** -0.5), plan.warps, plan.key_tile, plan.smem, stream)
    check(rc, "flash_fwd launch")
    COUNTER.add(shape=(bh, k.shape[0], s, t, d))
    record_work(COUNTER.name, work)
    return out, lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], out: torch.Tensor,
              lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None):
    """Layouts as ``flash_fwd``, plus its out (bh, s, d) and lse (bh, s)
    fp32 and the upstream gradient dout (bh, s, d) in q's dtype. Returns
    (dq, dk, dv) in the input dtype: dq (bh, s, d), dk/dv (bh // group,
    t, d) summed over each group's query heads. One call launches the
    delta kernel, then the tensor-core kernel (split 3×TF32 for f32) and,
    when ``bwd_plan`` splits the keys, the dq partial sum."""
    _check_inputs(q, k, v, bias)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != q.shape[:2]:
        raise ValueError(f"out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if q.device.type == "cpu" and not is_abstract(q):
        return flash_bwd_ref(q, k, v, bias, out, lse, dout, causal=causal,
                             window=window)
    _check_kernel_inputs("flash_bwd", q, k, v, bias, out, lse, dout)
    if out.dtype != q.dtype or dout.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise TypeError(f"flash_bwd takes out/dout in q's dtype and fp32 "
                        f"lse, got {out.dtype}/{dout.dtype}/{lse.dtype}")
    if any(misaligned(x) for x in (q, k, v, dout)):
        raise ValueError("the flash_bwd kernel copies 16-byte rows: q, k, "
                         "v and dout must start 16-byte aligned")
    bh, s, d = q.shape
    t = k.shape[1]
    plan = bwd_plan(bh, s, t, d, q.dtype)
    if plan.key_blocks > MAX_GRID_Y:
        raise ValueError(f"flash_bwd: t={t} needs {plan.key_blocks} key "
                         f"blocks of {plan.key_block}, more than the grid's "
                         f"{MAX_GRID_Y}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    dq_part = (torch.empty((plan.dq_part_floats,), dtype=torch.float32,
                           device=q.device) if plan.dq_part_floats else None)

    def work():
        return flash_bwd_work(bh, k.shape[0], s, t, d, q.element_size(),
                              causal=causal, window=window,
                              bias_rows=0 if bias is None else bias.shape[0])
    if is_abstract(q):
        record_work(BWD_COUNTER.name, work)
        return dq, dk, dv
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with device_scope(q.device):
        rc = BWD_LIB.lib().repro_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dq_part.data_ptr() if dq_part is not None else None,
            _DTYPES[q.dtype], bh, s, t, d, plan.key_block, plan.smem,
            bh // k.shape[0],
            bh // bias.shape[0] if bias is not None else 1, int(causal),
            window if window is not None else -1, float(d ** -0.5), stream)
    check(rc, "flash_bwd launch")
    BWD_COUNTER.add(shape=(bh, k.shape[0], s, t, d))
    record_work(BWD_COUNTER.name, work)
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
