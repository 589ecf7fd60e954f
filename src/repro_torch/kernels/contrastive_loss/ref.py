"""Plain PyTorch versions of the fused contrastive-loss kernels (port of
``repro/kernels/contrastive_loss/ref.py``).

They materialise the B×B similarity matrix, as paper Algorithm 1 line 6
does. ``contrastive_fwd_ref`` / ``contrastive_grads_ref`` are the
closed-form oracle of the loss and its gradients; ``fwd_fused_ref`` and
``bwd_fused_ref`` compute exactly what the kernels' two entry points
compute (the CPU path of ``ops.fwd_fused`` / ``ops.bwd_fused`` and the
yardstick the kernels are held against on the card), including the
``b_norm`` / ``with_diag`` arguments and the rounding of dA to bf16 before
the contractions when the inputs are bf16.
"""
from __future__ import annotations

from typing import Optional

import torch


def _scores(x, y, inv_tau):
    return (x.float() @ y.float().T) * inv_tau


def contrastive_fwd_ref(x, y, log_tau):
    """Returns (loss, row_lse (B,), col_lse (B,), diag (B,)), fp32."""
    a = _scores(x, y, torch.exp(-log_tau))
    row_lse = torch.logsumexp(a, dim=1)
    col_lse = torch.logsumexp(a, dim=0)
    diag = torch.diagonal(a)
    loss = 0.5 * (torch.mean(row_lse - diag) + torch.mean(col_lse - diag))
    return loss, row_lse, col_lse, diag


def contrastive_grads_ref(x, y, log_tau):
    """(dX, dY, dlog_tau) of the loss above in fp32, via the closed form
    dA = (softmax_row + softmax_col - 2I) / (2B)."""
    x32, y32 = x.float(), y.float()
    inv_tau = torch.exp(-log_tau)
    a = (x32 @ y32.T) * inv_tau
    b = a.shape[0]
    eye = torch.eye(b, dtype=torch.float32, device=a.device)
    da = (torch.softmax(a, dim=1) + torch.softmax(a, dim=0) - 2 * eye) / (
        2 * b)
    return (da @ y32) * inv_tau, (da.T @ x32) * inv_tau, -torch.sum(da * a)


def loss_ref(x, y, log_tau):
    """The scalar fp32 loss of paper Eq. 3."""
    return contrastive_fwd_ref(x, y, log_tau)[0]


def fwd_fused_ref(x, y, inv_tau):
    """What ``fwd_fused`` computes: (row_lse, col_lse), each (B,) fp32, of
    A = X·Yᵀ·inv_tau."""
    a = _scores(x, y, inv_tau)
    return torch.logsumexp(a, dim=1), torch.logsumexp(a, dim=0)


def bwd_fused_ref(x, y, inv_tau, row_lse, col_lse, *,
                  b_norm: Optional[int] = None, with_diag: bool = True):
    """What ``bwd_fused`` computes: (dX, dY, dlog_tau) in fp32 from the
    forward's row/column LSE. ``b_norm`` overrides the 1/(2B)
    normalisation; ``with_diag=False`` drops the -2·δ_ij term. For bf16
    inputs dA is rounded to bf16 before the two contractions, as the
    reference kernel's ``_contract`` does; dlog_tau uses the fp32 dA."""
    b = x.shape[0]
    a = _scores(x, y, inv_tau)
    da = torch.exp(a - row_lse[:, None]) + torch.exp(a - col_lse[None, :])
    if with_diag:
        da = da - 2.0 * torch.eye(b, dtype=torch.float32, device=a.device)
    da = da / (2.0 * (b if b_norm is None else b_norm))
    op = da.to(x.dtype).float()
    dx = (op @ y.float()) * inv_tau
    dy = (op.T @ x.float()) * inv_tau
    return dx, dy, -torch.sum(da * a)
