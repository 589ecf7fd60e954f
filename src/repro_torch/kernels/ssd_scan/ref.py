"""Plain PyTorch versions of the Mamba-2 SSD scan (the counterparts of
``repro/kernels/ssd_scan/ref.py`` and ``repro/models/ssm.py``'s
``ssd_chunked``).

``ssd_ref`` is the sequential recurrence

    h_t = exp(dt_t · A) h_{t-1} + dt_t x_t ⊗ B_t ;   y_t = h_t C_t + D x_t

and ``ssd_chunked`` the chunked dual form that the model runs: an
intra-chunk quadratic term, per-chunk states and an inter-chunk
recurrence. Both take an initial state and return the final one, and
compute in fp32 whatever the input dtype. ``ssd_chunked`` is the CPU path
of ``ops.ssd_scan`` and the yardstick the kernel is held against on the
card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def chunk_of(l: int, chunk: int) -> int:
    """The chunk a sequence of ``l`` tokens is scanned in: ``min(chunk,
    l)``, which must divide ``l`` (the reference's rule, so a sequence is
    at most one chunk long or a whole number of chunks). Raises
    ``ValueError`` otherwise."""
    if l < 1 or chunk < 1:
        raise ValueError(f"SSD scan needs l >= 1 and chunk >= 1, got l={l}, "
                         f"chunk={chunk}")
    c = min(chunk, l)
    if l % c:
        raise ValueError(f"SSD scan: sequence length {l} must be at most the "
                         f"chunk {chunk} or a multiple of it (chunk = "
                         f"min(chunk, l) must divide l)")
    return c


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., t) -> (..., t, t) lower-triangular pairwise cumulative sums:
    out[..., i, j] = sum_{k=j+1..i} a[..., k] for i >= j, -inf above the
    diagonal (so ``exp`` of it is exactly 0 there, never inf)."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None, D=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x (b, l, h, p); dt (b, l, h) softplus'd step sizes; A (h,) negative
    decay rates; Bm/Cm (b, l, n), one group shared by every head;
    init_state (b, h, p, n) or None (zeros); D (h,) or None. The chunk is
    ``chunk_of(l, chunk)``. Returns (y (b, l, h, p), final_state
    (b, h, p, n)), both fp32; y includes ``D·x`` when D is given."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    c = chunk_of(l, chunk)
    nc = l // c
    xf, dtf = x.float(), dt.float()
    xc = (xf * dtf[..., None]).reshape(b, nc, c, h, p)
    da = (dtf * A.float()).reshape(b, nc, c, h).permute(0, 3, 1, 2)
    Bc = Bm.float().reshape(b, nc, c, n)
    Cc = Cm.float().reshape(b, nc, c, n)

    # 1) intra-chunk (quadratic, "attention-like") term
    Lmat = torch.exp(segsum(da))                        # (b, h, nc, c, c)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, Lmat, xc)

    # 2) per-chunk states (each chunk's contribution to the carried state)
    da_cum = torch.cumsum(da, dim=-1)                   # (b, h, nc, c)
    decay_to_end = torch.exp(da_cum[..., -1:] - da_cum)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_to_end, xc)

    # 3) inter-chunk recurrence
    chunk_decay = torch.exp(da_cum[..., -1])            # (b, h, nc)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    states_in = []
    for ci in range(nc):
        states_in.append(carry)
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    states_in = torch.stack(states_in, dim=1)           # (b, nc, h, p, n)

    # 4) inter-chunk output: the carried state's decayed contribution
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states_in,
                         torch.exp(da_cum))
    y = (y_diag + y_off).reshape(b, l, h, p)
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y, carry


def ssd_ref(x, dt, A, Bm, Cm, D=None, init_state: Optional[torch.Tensor]
            = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence, one token at a time, in fp32. Shapes as
    ``ssd_chunked``. Returns (y (b, l, h, p), final_state (b, h, p, n))."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    Af = A.float()
    ys = []
    for t in range(l):
        dtt = dt[:, t].float()                                    # (b, h)
        decay = torch.exp(dtt * Af)
        dx = dtt[..., None] * x[:, t].float()                     # (b, h, p)
        state = (state * decay[..., None, None]
                 + dx[..., None] * Bm[:, t].float()[:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t].float()))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y, state
