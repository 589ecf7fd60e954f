"""Image-text contrastive loss (paper §3, Eqs. 1-3; port of
``repro/core/contrastive.py``).

A = (X^T Y) / tau; loss = (RowLoss + ColumnLoss) / 2, where each is a
softmax cross-entropy against the diagonal. ``contrastive_loss`` is the
reference form (it materialises the B×B matrix, as paper Algorithm 1 line
6 does); ``fused_kernel_loss`` computes the same value and gradients through
the hand-written kernels of ``repro_torch.kernels.contrastive_loss`` without
storing A.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.contrastive_loss.ops import fused_contrastive_loss


def similarity(x_emb, y_emb, tau):
    """A_ij = <F(x_i), G(y_j)> / tau. x_emb / y_emb: (B, D) unit-norm."""
    return torch.einsum("id,jd->ij", x_emb, y_emb) / tau


def contrastive_loss(x_emb, y_emb, tau, label_smoothing: float = 0.0):
    """Paper Eq. 3 in fp32. Returns (loss, metrics): row and column losses
    and the image-to-text top-1 accuracy within the batch."""
    b = x_emb.shape[0]
    a = similarity(x_emb.float(), y_emb.float(), tau)
    labels = torch.arange(b, device=a.device)
    row_lse = torch.logsumexp(a, dim=1)
    col_lse = torch.logsumexp(a, dim=0)
    diag = torch.diagonal(a)
    if label_smoothing:
        eps = label_smoothing
        row_tgt = (1 - eps) * diag + eps * torch.mean(a, dim=1)
        col_tgt = (1 - eps) * diag + eps * torch.mean(a, dim=0)
    else:
        row_tgt, col_tgt = diag, diag
    row_loss = torch.mean(row_lse - row_tgt)
    col_loss = torch.mean(col_lse - col_tgt)
    loss = 0.5 * (row_loss + col_loss)
    acc = torch.mean((torch.argmax(a, dim=1) == labels).float())
    return loss, {"row_loss": row_loss, "col_loss": col_loss,
                  "i2t_top1": acc}


def fused_kernel_loss(x_emb, y_emb, tau):
    """The value and gradients of ``contrastive_loss`` through the fused
    kernels (one forward, one backward launch; the plain versions on a CPU
    tensor). bf16 embeddings pass through unconverted. A drop-in
    ``loss_fn`` for ``core.gradaccum``; its metrics are zeros, as in the
    reference, since the accuracy would need the full matrix."""
    loss = fused_contrastive_loss(x_emb, y_emb, torch.log(tau))
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"row_loss": zero, "col_loss": zero, "i2t_top1": zero}


def normalized_train_loss(x_emb, y_emb):
    """Paper §6 normalised loss: -exp(F(x_i)^T G(y_i)) /
    (1/B sum_k exp(F(x_i)^T G(y_k))). Returns the per-example vector
    (B,)."""
    s = torch.einsum("id,jd->ij", x_emb, y_emb)          # (B, B), tau = 1
    num = torch.exp(torch.diagonal(s))
    den = torch.mean(torch.exp(s), dim=1)
    return -num / den
