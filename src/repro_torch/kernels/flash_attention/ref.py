"""Plain PyTorch versions of the flash-attention forward and backward
kernels.

Both materialise the (s, t) score matrix on the kernels' flattened-head
layout. ``flash_fwd_ref`` returns the same ``(out, lse)`` pair the forward
kernel does; ``flash_bwd_ref`` returns the same ``(dq, dk, dv)`` as the
backward kernel, written from the formula (p recomputed from ``lse``,
delta = rowsum(dout·out)) rather than by autograd of the forward. They are
the CPU path of ``ops.flash_fwd`` / ``ops.flash_bwd`` and the yardstick the
kernels are held against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _scores(q, k, v, bias, causal, window):
    """(q·d^-1/2, k, v with kv rows repeated over their group, masked
    scores (bh, s, t)), all fp32."""
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
    return qf, kf, vf, scores


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *, causal: bool = True,
                  window: Optional[int] = None):
    """q: (bh, s, d); k/v: (bh // group, t, d), query row ``i`` reading kv
    row ``i // group``; bias: optional (bh // heads, t) fp32 additive key
    bias, query row ``i`` reading bias row ``i // heads``. Returns
    (out (bh, s, d) in q's dtype, lse (bh, s) fp32)."""
    qf, kf, vf, scores = _scores(q, k, v, bias, causal, window)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    out = torch.matmul(p, vf)
    return out.to(q.dtype), lse


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], out: torch.Tensor,
                  lse: torch.Tensor, dout: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None):
    """Layouts as ``flash_fwd_ref``, plus the forward's out (bh, s, d), lse
    (bh, s) fp32 and the upstream dout (bh, s, d). Recomputes
    p = exp(s − lse) (masked entries give exp(NEG_INF − lse) = 0) and, in
    fp32, delta = rowsum(dout·out), ds = p·(dout·vᵀ − delta); returns
    (dq, dk, dv) in the input dtypes, dk and dv summed over the query heads
    of each kv row's group."""
    bh, s, d = q.shape
    bkv, t = k.shape[0], k.shape[1]
    qf, kf, vf, scores = _scores(q, k, v, bias, causal, window)
    p = torch.exp(scores - lse.float()[..., None])         # (bh, s, t)
    do = dout.float()
    delta = torch.sum(do * out.float(), dim=-1)            # (bh, s)
    ds = p * (torch.matmul(do, vf.transpose(1, 2)) - delta[..., None])
    dq = torch.matmul(ds, kf) * (d ** -0.5)
    # qf is pre-scaled by d^-1/2, so dsᵀ·qf IS dk
    dk = torch.matmul(ds.transpose(1, 2), qf).reshape(bkv, -1, t, d).sum(1)
    dv = torch.matmul(p.transpose(1, 2), do).reshape(bkv, -1, t, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
