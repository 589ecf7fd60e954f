"""Plain PyTorch version of the fused similarity→top-k kernel.

Materialises the full (b, n) logit matrix and takes a stable sort of the
negated logits, so equal values keep ascending class order: values
descending, ties to the lower class id, the ordering the kernel must give
without ever forming the matrix.
"""
from __future__ import annotations

import torch


def logits_ref(image_emb: torch.Tensor, class_emb: torch.Tensor,
               inv_tau: float = 1.0) -> torch.Tensor:
    """The materialising similarity matrix (b, n) in fp32."""
    return torch.matmul(image_emb.float(), class_emb.float().T) * inv_tau


def similarity_topk_ref(image_emb: torch.Tensor, class_emb: torch.Tensor,
                        k: int, inv_tau: float = 1.0):
    """Top-k of ``image_emb @ class_emb.T * inv_tau`` per row. Returns
    (values (b, k) fp32, indices (b, k) int32), sorted descending, ties
    broken by the lower class id."""
    logits = logits_ref(image_emb, class_emb, inv_tau)
    order = torch.sort(-logits, dim=1, stable=True).indices[:, :k]
    return torch.gather(logits, 1, order), order.to(torch.int32)


def classify_ref(image_emb: torch.Tensor, class_emb: torch.Tensor,
                 inv_tau: float = 1.0) -> torch.Tensor:
    """argmax class id per row (b,) int32: the top-1 of the plain
    version."""
    _, idx = similarity_topk_ref(image_emb, class_emb, 1, inv_tau)
    return idx[:, 0]
