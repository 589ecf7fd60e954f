"""Plain PyTorch versions of the Mamba-2 SSD scan (the counterparts of
``repro/kernels/ssd_scan/ref.py`` and ``repro/models/ssm.py``'s
``ssd_chunked``).

``ssd_ref`` is the sequential recurrence

    h_t = exp(dt_t · A) h_{t-1} + dt_t x_t ⊗ B_t ;   y_t = h_t C_t + D x_t

and ``ssd_chunked`` the chunked dual form that the model runs: an
intra-chunk quadratic term, per-chunk states and an inter-chunk
recurrence. Both take an initial state and return the final one, and
compute in fp32 whatever the input dtype (in float64 for float64 inputs,
for ``gradcheck``). ``ssd_chunked`` is the CPU path of ``ops.ssd_scan``
and the yardstick the kernel is held against on the card.

``ssd_chunked_bwd`` is the scan's backward written out in the chunked
order that ``csrc/ssd_bwd.cu`` computes it (the reference has no such
function: XLA differentiates its jnp ``ssd_chunked``). With a_t =
exp(dt_t·A), u_t = dt_t·x_t and h_t the state after token t, the gradient
G_t of the loss by h_t runs backwards,

    G_t = dy_t ⊗ C_t + a_{t+1}·G_{t+1},   G_l = dy_l ⊗ C_l + dfinal,

and du_t = G_t·B_t, dx_t = dt_t·du_t + D·dy_t, dB_t = Σ_{h,p} G_t·u_t,
dC_t = Σ_{h,p} h_t·dy_t, da_t = ⟨G_t, h_{t−1}⟩, ddt_t = ⟨du_t, x_t⟩ +
A·a_t·da_t, dA = Σ dt_t·a_t·da_t, dD = Σ dy_t·x_t, d(init) = a_1·G_1.
Inside a chunk these become products of (c × c) matrices with the
forward's decay mask, and only the carried G (``R`` below) and the
carried state cross chunk boundaries.
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
    ct = _compute_dtype(x, dt, A, Bm, Cm, init_state, D)
    xf, dtf = x.to(ct), dt.to(ct)
    xc = (xf * dtf[..., None]).reshape(b, nc, c, h, p)
    da = (dtf * A.to(ct)).reshape(b, nc, c, h).permute(0, 3, 1, 2)
    Bc = Bm.to(ct).reshape(b, nc, c, n)
    Cc = Cm.to(ct).reshape(b, nc, c, n)

    # 1) intra-chunk (quadratic, "attention-like") term
    Lmat = torch.exp(segsum(da))                        # (b, h, nc, c, c)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, Lmat, xc)

    # 2) per-chunk states (each chunk's contribution to the carried state)
    da_cum = torch.cumsum(da, dim=-1)                   # (b, h, nc, c)
    decay_to_end = torch.exp(da_cum[..., -1:] - da_cum)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_to_end, xc)

    # 3) inter-chunk recurrence
    states_in, carry = _pass_states(states, da_cum, init_state, ct)

    # 4) inter-chunk output: the carried state's decayed contribution
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states_in,
                         torch.exp(da_cum))
    y = (y_diag + y_off).reshape(b, l, h, p)
    if D is not None:
        y = y + D.to(ct)[None, None, :, None] * xf
    return y, carry


def _compute_dtype(*tensors) -> torch.dtype:
    """float64 when any of ``tensors`` is, else float32."""
    return (torch.float64 if any(t is not None and t.dtype == torch.float64
                                 for t in tensors) else torch.float32)


def _pass_states(states, da_cum, init_state, ct):
    """(the state entering each chunk (b, nc, h, p, n), the final state):
    the inter-chunk recurrence over the chunks' own ``states`` (b, nc, h,
    p, n) with decay exp(da_cum[..., -1]) a chunk."""
    b, nc, h, p, n = states.shape
    chunk_decay = torch.exp(da_cum[..., -1])            # (b, h, nc)
    carry = (torch.zeros((b, h, p, n), dtype=ct, device=states.device)
             if init_state is None else init_state.to(ct))
    states_in = []
    for ci in range(nc):
        states_in.append(carry)
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    return torch.stack(states_in, dim=1), carry


def ssd_chunked_bwd(x, dt, A, Bm, Cm, D, init_state, dy, dfinal, chunk: int):
    """The backward of ``ssd_chunked`` (y with ``D·x`` when D is given):
    given dy (b, l, h, p), the gradient of y, and dfinal (b, h, p, n) or
    None (zeros), that of the final state, returns (dx, ddt, dA, dBm, dCm,
    dD, d_init_state) in fp32 (float64 for float64 inputs); dD is None
    when D is, d_init_state when init_state is. Computed chunk by chunk in
    the kernel's order: the chunk's decay mask L (L[i, j] = exp(cs_i −
    cs_j) for j <= i, cs the running sum of dt·A in the chunk), W = L ⊙
    C·Bᵀ and V = L ⊙ dy·uᵀ (per head; dy·uᵀ sums over p); the gradient R
    carried into each chunk from the later ones, R ← exp(cs_last)·R +
    Σ_j exp(cs_j)·dy_j ⊗ C_j from dfinal; then, with S0 the state entering
    the chunk,

        du  = Wᵀ·dy + exp(cs_last − cs)·(B·Rᵀ)
        dB  = Σ_h Vᵀ·C + exp(cs_last − cs)·(u·R)
        dC  = Σ_h V·B + exp(cs)·(dy·S0)

    and the gradient of cs: the rows minus the columns of V ⊙ C·Bᵀ, plus
    exp(cs)·⟨dy, S0·C⟩, minus exp(cs_last − cs)·⟨u, R·B⟩, plus ⟨R, the
    state leaving the chunk⟩ at the chunk's last token; its running sum
    from the chunk's end is the gradient of each token's log-decay dt·A."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    c = chunk_of(l, chunk)
    nc = l // c
    ct = _compute_dtype(x, dt, A, Bm, Cm, init_state, D, dy, dfinal)
    xf, dtf, Af = x.to(ct), dt.to(ct), A.to(ct)
    xc = xf.reshape(b, nc, c, h, p)
    uc = (xf * dtf[..., None]).reshape(b, nc, c, h, p)
    dyc = dy.to(ct).reshape(b, nc, c, h, p)
    da = (dtf * Af).reshape(b, nc, c, h).permute(0, 3, 1, 2)  # (b,h,nc,c)
    Bc = Bm.to(ct).reshape(b, nc, c, n)
    Cc = Cm.to(ct).reshape(b, nc, c, n)
    cs = torch.cumsum(da, dim=-1)                       # (b, h, nc, c)
    ecs = torch.exp(cs)
    dec = torch.exp(cs[..., -1:] - cs)                  # to the chunk's end

    # the forward's states: entering each chunk, and leaving it
    local = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, dec, uc)
    states_in, final = _pass_states(local, cs, init_state, ct)
    states_out = torch.cat([states_in[:, 1:], final[:, None]], dim=1)

    # the gradient carried into each chunk from the later ones
    r_local = torch.einsum("bhcl,bclhp,bcln->bchpn", ecs, dyc, Cc)
    chunk_decay = torch.exp(cs[..., -1])                # (b, h, nc)
    carry = (torch.zeros((b, h, p, n), dtype=ct, device=x.device)
             if dfinal is None else dfinal.to(ct))
    r_in = [None] * nc
    for ci in reversed(range(nc)):
        r_in[ci] = carry
        carry = carry * chunk_decay[:, :, ci, None, None] + r_local[:, ci]
    r_in = torch.stack(r_in, dim=1)                     # (b, nc, h, p, n)
    d_init = None if init_state is None else carry

    lmask = torch.exp(segsum(da))                       # (b, h, nc, c, c)
    w = lmask * torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, None]
    dyu = torch.einsum("bcihp,bcjhp->bhcij", dyc, uc)
    v = lmask * dyu
    s = dyu * w

    brt = torch.einsum("bcin,bchpn->bcihp", Bc, r_in)   # (R·B_i)[p]
    dec_t = dec.permute(0, 2, 3, 1)[..., None]          # (b, nc, c, h, 1)
    du = torch.einsum("bhcji,bcjhp->bcihp", w, dyc) + dec_t * brt
    dx = dtf[..., None] * du.reshape(b, l, h, p)
    if D is not None:
        dx = dx + D.to(ct)[None, None, :, None] * dy.to(ct)
    dB = (torch.einsum("bhcji,bcjn->bcin", v, Cc)
          + torch.einsum("bhci,bcihp,bchpn->bcin", dec, uc, r_in))
    dC = (torch.einsum("bhcij,bcjn->bcin", v, Bc)
          + torch.einsum("bhci,bcihp,bchpn->bcin", ecs, dyc, states_in))

    dcs = (s.sum(-1) - s.sum(-2)
           + ecs * torch.einsum("bcihp,bchpn,bcin->bhci", dyc, states_in, Cc)
           - dec * torch.einsum("bcihp,bcihp->bhci", uc, brt))
    dcs[..., -1] += torch.einsum("bchpn,bchpn->bhc", r_in, states_out)
    dl = torch.flip(torch.cumsum(torch.flip(dcs, [-1]), -1), [-1])
    dl = dl.permute(0, 2, 3, 1).reshape(b, l, h)        # by log-decay
    ddt = (du * xc).sum(-1).reshape(b, l, h) + Af * dl
    dA = (dtf * dl).sum((0, 1))
    dD = None if D is None else (dy.to(ct) * xf).sum((0, 1, 3))
    return (dx, ddt, dA, dB.reshape(b, l, n), dC.reshape(b, l, n), dD,
            d_init)


def ssd_ref(x, dt, A, Bm, Cm, D=None, init_state: Optional[torch.Tensor]
            = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence, one token at a time, in fp32. Shapes as
    ``ssd_chunked``. Returns (y (b, l, h, p), final_state (b, h, p, n))."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    ct = _compute_dtype(x, dt, A, Bm, Cm, D, init_state)
    state = (torch.zeros((b, h, p, n), dtype=ct, device=x.device)
             if init_state is None else init_state.to(ct))
    Af = A.to(ct)
    ys = []
    for t in range(l):
        dtt = dt[:, t].to(ct)                                     # (b, h)
        decay = torch.exp(dtt * Af)
        dx = dtt[..., None] * x[:, t].to(ct)                      # (b, h, p)
        state = (state * decay[..., None, None]
                 + dx[..., None] * Bm[:, t].to(ct)[:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t].to(ct)))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.to(ct)[None, None, :, None] * x.to(ct)
    return y, state
