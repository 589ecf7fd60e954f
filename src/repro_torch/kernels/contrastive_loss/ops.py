"""Fused contrastive loss: the wrappers of ``csrc/contrastive.cu`` and the
differentiable loss built on them.

``fwd_fused(x, y, inv_tau)`` returns the row and column LSE of
X·Yᵀ·inv_tau, as the reference's ``fwd_fused`` does
(``repro/kernels/contrastive_loss/kernel.py:107``); ``bwd_fused`` returns
dX, dY and dlog_tau from them, with the ``b_norm`` and ``with_diag``
arguments of the reference's ``bwd_fused`` (``kernel.py:185``).
``fused_contrastive_loss(x, y, log_tau)`` is the ``torch.autograd.Function``
counterpart of the reference's custom VJP (``ops.py:147-188``): one forward
call, one backward call, and the B×B matrix never reaches device memory.

On a CPU tensor the wrappers run the plain versions in ``ref.py``; on a
CUDA tensor they launch the kernels or raise. ``inv_tau`` stays on the
device (a 0-d tensor), so no wrapper synchronises with the host.

What does not carry over from the TPU module: its VMEM block model
(``pick_blocks``, ``autotune_blocks``, ``bwd_fits_fused``) and the
compiled-mode fallback to the legacy two-sweep ``kernel.grads`` when the
VMEM-resident (B, D) dY carrier does not fit (``ops.py:179-184``). The
Hopper kernels keep no resident dY: dY comes from its own column-parallel
launch, so there is nothing to fall back from, and any B >= 1 is taken
(the reference asks for B % 8 == 0).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Union

import torch

from repro_torch.kernels.build import KernelLibrary, LaunchCounter, check
from repro_torch.kernels.contrastive_loss.ref import (bwd_fused_ref,
                                                      fwd_fused_ref)

MAX_D = 1024          # the backward keeps its dX / dY rows in shared memory
FWD_TILE = 64         # edge of the forward's A tile (csrc kTile)
BWD_ROWS = 16         # rows of X (Y) per backward CTA (csrc kRows)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLibrary(
    "contrastive",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "contrastive.cu"),
    {"repro_contrastive_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _P]),
     "repro_contrastive_bwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, ctypes.c_float, _I, _P])})
FWD_COUNTER = LaunchCounter("contrastive_fwd")
BWD_COUNTER = LaunchCounter("contrastive_bwd")


def _inv_tau_tensor(inv_tau: Union[float, torch.Tensor], like: torch.Tensor
                    ) -> torch.Tensor:
    """inv_tau as a 0-d fp32 tensor on ``like``'s device."""
    if isinstance(inv_tau, torch.Tensor):
        return inv_tau.detach().reshape(()).to(torch.float32)
    return torch.tensor(float(inv_tau), dtype=torch.float32,
                        device=like.device)


def _check_kernel_inputs(what: str, x, y, *rest):
    if x.dim() != 2 or y.shape != x.shape or x.shape[0] < 1:
        raise ValueError(f"{what}: expected x, y of one (B, D) shape, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"{what} kernel takes f32 or bf16 x/y of one dtype, "
                        f"got {x.dtype}/{y.dtype}")
    if any(t.device != x.device for t in (y, *rest)):
        raise ValueError(f"{what}: all tensors must be on one device")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous x, y")


def fwd_fused(x: torch.Tensor, y: torch.Tensor,
              inv_tau: Union[float, torch.Tensor]):
    """x, y: (B, D) f32 or bf16; inv_tau: scalar. Returns (row_lse,
    col_lse), each (B,) fp32, of A = X·Yᵀ·inv_tau."""
    inv = _inv_tau_tensor(inv_tau, x)
    if x.device.type == "cpu":
        return fwd_fused_ref(x, y, inv)
    _check_kernel_inputs("fwd_fused", x, y, inv)
    b, d = x.shape
    n = -(-b // FWD_TILE)
    row_lse = torch.empty((b,), dtype=torch.float32, device=x.device)
    col_lse = torch.empty((b,), dtype=torch.float32, device=x.device)
    part = torch.empty((4 * n * b,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = LIB.lib().repro_contrastive_fwd(
            x.data_ptr(), y.data_ptr(), inv.data_ptr(), row_lse.data_ptr(),
            col_lse.data_ptr(), part.data_ptr(), _DTYPES[x.dtype], b, d,
            stream)
    check(rc, "contrastive fwd_fused launch")
    FWD_COUNTER.add()
    return row_lse, col_lse


def bwd_fused(x: torch.Tensor, y: torch.Tensor,
              inv_tau: Union[float, torch.Tensor], row_lse: torch.Tensor,
              col_lse: torch.Tensor, *, b_norm: Optional[int] = None,
              with_diag: bool = True):
    """Returns (dX, dY, dlog_tau) in fp32 from the forward's row/column LSE.
    ``b_norm`` overrides the 1/(2B) normalisation batch; ``with_diag=False``
    drops the -2·δ_ij positive-pair term."""
    inv = _inv_tau_tensor(inv_tau, x)
    if x.device.type == "cpu":
        return bwd_fused_ref(x, y, inv, row_lse, col_lse, b_norm=b_norm,
                             with_diag=with_diag)
    _check_kernel_inputs("bwd_fused", x, y, inv, row_lse, col_lse)
    b, d = x.shape
    if d > MAX_D:
        raise ValueError(f"bwd_fused kernel takes D <= {MAX_D}, got {d}")
    row_lse = row_lse.float().contiguous()
    col_lse = col_lse.float().contiguous()
    if row_lse.shape != (b,) or col_lse.shape != (b,):
        raise ValueError(f"row/col lse must be ({b},), got "
                         f"{tuple(row_lse.shape)}, {tuple(col_lse.shape)}")
    dx = torch.empty((b, d), dtype=torch.float32, device=x.device)
    dy = torch.empty((b, d), dtype=torch.float32, device=x.device)
    dtau = torch.empty((), dtype=torch.float32, device=x.device)
    part = torch.empty((-(-b // BWD_ROWS),), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = LIB.lib().repro_contrastive_bwd(
            x.data_ptr(), y.data_ptr(), inv.data_ptr(), row_lse.data_ptr(),
            col_lse.data_ptr(), dx.data_ptr(), dy.data_ptr(),
            dtau.data_ptr(), part.data_ptr(), _DTYPES[x.dtype], b, d,
            float(2.0 * (b if b_norm is None else b_norm)), int(with_diag),
            stream)
    check(rc, "contrastive bwd_fused launch")
    BWD_COUNTER.add()
    return dx, dy, dtau


def _fwd(x, y, log_tau):
    inv_tau = torch.exp(-log_tau.float())
    row_lse, col_lse = fwd_fused(x, y, inv_tau)
    diag = torch.sum(x.float() * y.float(), dim=1) * inv_tau
    loss = 0.5 * (torch.mean(row_lse - diag) + torch.mean(col_lse - diag))
    return loss, inv_tau, row_lse, col_lse


class _FusedContrastiveLoss(torch.autograd.Function):
    """Paper Eq. 3 through the fused kernels: one forward launch, one
    backward launch (the reference's ``_fwd`` / ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, y, log_tau):
        loss, inv_tau, row_lse, col_lse = _fwd(x.detach(), y.detach(),
                                               log_tau.detach())
        ctx.save_for_backward(x, y, inv_tau, row_lse, col_lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, y, inv_tau, row_lse, col_lse = ctx.saved_tensors
        dx, dy, dtau = bwd_fused(x, y, inv_tau, row_lse, col_lse)
        return (g * dx).to(x.dtype), (g * dy).to(y.dtype), g * dtau


def fused_contrastive_loss(x: torch.Tensor, y: torch.Tensor,
                           log_tau: torch.Tensor) -> torch.Tensor:
    """x, y: (B, D) fp32/bf16 unit-norm embeddings; log_tau: scalar fp32.
    Returns the scalar fp32 loss 0.5·(mean(row_lse − diag) +
    mean(col_lse − diag)); differentiable in all three (dX, dY in the
    input dtype, dlog_tau fp32)."""
    return _FusedContrastiveLoss.apply(x, y, log_tau)


def fused_loss_and_lse(x: torch.Tensor, y: torch.Tensor,
                       log_tau: torch.Tensor):
    """Non-differentiable entry returning (loss, row_lse, col_lse) for
    diagnostics: a scalar fp32 loss and two (B,) fp32 LSE vectors."""
    with torch.no_grad():
        loss, _, row_lse, col_lse = _fwd(x, y, log_tau)
    return loss, row_lse, col_lse
