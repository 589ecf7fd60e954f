"""Plain PyTorch version of the fused similarity→top-k kernel.

Materialises the full (b, n) logit matrix and takes a stable sort of the
negated logits, so equal values keep ascending class order: values
descending, ties to the lower class id, the ordering the kernel must give
without ever forming the matrix. Columns at or past ``n_valid`` are masked
to ``NEG`` before the sort and keep their own ids, as the reference
kernel's runtime mask does.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30          # sentinel value: below any real similarity


def logits_ref(image_emb: torch.Tensor, class_emb: torch.Tensor,
               inv_tau: float = 1.0) -> torch.Tensor:
    """The materialising similarity matrix (b, n) in fp32."""
    return torch.matmul(image_emb.float(), class_emb.float().T) * inv_tau


def similarity_topk_ref(image_emb: torch.Tensor, class_emb: torch.Tensor,
                        k: int, inv_tau: float = 1.0,
                        n_valid: Optional[int] = None):
    """Top-k of ``image_emb @ class_emb.T * inv_tau`` per row. Returns
    (values (b, k) fp32, indices (b, k) int32), sorted descending, ties
    broken by the lower class id; classes at or past ``n_valid`` (None:
    none) score ``NEG``."""
    logits = logits_ref(image_emb, class_emb, inv_tau)
    if n_valid is not None and n_valid < logits.shape[1]:
        col = torch.arange(logits.shape[1], device=logits.device)
        logits = torch.where(col < n_valid, logits,
                             torch.full_like(logits, NEG))
    order = torch.sort(-logits, dim=1, stable=True).indices[:, :k]
    return torch.gather(logits, 1, order), order.to(torch.int32)


def classify_ref(image_emb: torch.Tensor, class_emb: torch.Tensor,
                 inv_tau: float = 1.0) -> torch.Tensor:
    """argmax class id per row (b,) int32: the top-1 of the plain
    version."""
    _, idx = similarity_topk_ref(image_emb, class_emb, 1, inv_tau)
    return idx[:, 0]
