"""Plain PyTorch version of single-token decode attention over a (ring) KV
cache (the counterpart of ``repro/kernels/decode_attention/ref.py``).

It is the CPU path of ``ops.decode_attention`` and the yardstick the
kernel is held against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor, return_lse: bool = False):
    """q: (b, h, d) one query per head; k/v: (b, kv, t, d) cache; valid:
    (t,) bool mask of live cache slots, or (b, t) bool per slot. Scores,
    mask and softmax in fp32 (``NEG_INF`` at masked keys), then the
    weighted sum. Rows whose mask is all False (an empty slot) return
    exact zeros. Returns (b, h, d) in q's dtype; with ``return_lse`` also
    each row's fp32 log-sum-exp of its masked scaled scores (b, h),
    ``NEG_INF`` where the row has no valid key."""
    b, h, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = h // kv
    if valid.dim() == 1:
        valid = valid[None, :].expand(b, t)
    qg = q.reshape(b, kv, g, d).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) * (d ** -0.5)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", w, v.float())
    live = valid.any(dim=1)[:, None, None]
    out = torch.where(live[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    out = out.reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(live, torch.logsumexp(s, dim=-1),
                      torch.full((), NEG_INF, device=s.device))
    return out, lse.reshape(b, h)
