"""Plain PyTorch version of the flash-attention forward kernel.

Materialises the (s, t) score matrix and returns the same ``(out, lse)``
pair the kernel does, on the same flattened-head layout: the CPU path of
``ops.flash_fwd`` and the yardstick the kernel is held against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *, causal: bool = True,
                  window: Optional[int] = None):
    """q: (bh, s, d); k/v: (bh // group, t, d), query row ``i`` reading kv
    row ``i // group``; bias: optional (bh // heads, t) fp32 additive key
    bias, query row ``i`` reading bias row ``i // heads``. Returns
    (out (bh, s, d) in q's dtype, lse (bh, s) fp32)."""
    bh, s, d = q.shape
    t = k.shape[1]
    group = bh // k.shape[0]
    qf = q.float() * (d ** -0.5)
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    scores = torch.matmul(qf, kf.transpose(1, 2))          # (bh, s, t)
    if bias is not None:
        scores = scores + bias.float().repeat_interleave(
            bh // bias.shape[0], dim=0)[:, None, :]
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    valid = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        valid &= cols <= rows
    if window is not None:
        valid &= (rows - cols) < window
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    out = torch.matmul(p, vf)
    return out.to(q.dtype), lse
