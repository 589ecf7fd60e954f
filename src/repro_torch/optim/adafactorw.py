"""AdaFactorW (paper App. B): AdaFactor's factored second moment, AdamW's
decoupled weight decay, and a first moment stored in bf16 and used in f32
(port of ``repro/optim/adafactorw.py:1-115``).

The (init, update) style of the reference, on the port's dict trees:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr)
    params = apply_updates(params, updates)

Second moments of matrices (ndim >= 2, both trailing dims >=
factored_threshold) are stored as row/column running means; smaller
tensors keep a full second moment. Updates are RMS-clipped, then the
decoupled weight decay is added. Nothing is updated in place: ``update``
returns fresh trees, as the reference does.

``update_from_microbatches`` wires in ``core/moment_accum.py``: the
microbatch gradient stream is folded straight into the moment slots (paper
§4.2) without allocating the averaged gradient ḡ. (Factored second-moment
rows and columns are linear in g², so the E[c²] accumulation is exact for
them.)
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.core import moment_accum as ma
from repro_torch.tree import tree_leaves, tree_map


class AdaFactorWState(NamedTuple):
    """Optimizer slots: a 0-d int32 step count, the first moment (bf16
    leaves), the factored second-moment rows (or the full second moment of
    a small leaf) and columns (a 0-d placeholder for a small leaf)."""
    step: torch.Tensor
    m: dict
    v_row: dict
    v_col: dict


def _factored(x: torch.Tensor, threshold: int) -> bool:
    return x.dim() >= 2 and x.shape[-1] >= threshold and \
        x.shape[-2] >= threshold


class AdaFactorW:
    """The optimizer's hyper-parameters and its init / update rules."""

    def __init__(self, beta1=0.9, beta2=0.99, eps=1e-30, weight_decay=0.0,
                 clip_threshold=1.0, factored_threshold=128,
                 store_m_bf16=True):
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay
        self.clip_threshold = clip_threshold
        self.factored_threshold = factored_threshold
        self.store_m_bf16 = store_m_bf16

    # -- state ------------------------------------------------------------
    def init(self, params) -> AdaFactorWState:
        """Zeroed slots for ``params`` on the params' device."""
        mdt = torch.bfloat16 if self.store_m_bf16 else torch.float32

        def vrow(p):
            if _factored(p, self.factored_threshold):
                return torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=p.device)
            return torch.zeros_like(p, dtype=torch.float32)

        def vcol(p):
            if _factored(p, self.factored_threshold):
                return torch.zeros((*p.shape[:-2], p.shape[-1]),
                                   dtype=torch.float32, device=p.device)
            return torch.zeros((), dtype=torch.float32, device=p.device)

        device = tree_leaves(params)[0].device
        return AdaFactorWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
            v_row=tree_map(vrow, params), v_col=tree_map(vcol, params))

    # -- core update ------------------------------------------------------
    def _precondition(self, g, vr, vc, p):
        if _factored(p, self.factored_threshold):
            r = vr[..., None]                               # (..., rows, 1)
            c = vc[..., None, :]                            # (..., 1, cols)
            mean_r = torch.mean(vr, dim=-1, keepdim=True)[..., None]
            denom = torch.sqrt(r * c / torch.clamp(mean_r, min=self.eps))
            return g / torch.clamp(denom, min=self.eps ** 0.5)
        return g / torch.sqrt(vr + self.eps)

    def _new_v(self, g2, vr, vc, p):
        """The second-moment slots after taking in ``g2`` (E[g²] + eps)."""
        if _factored(p, self.factored_threshold):
            nvr = self.beta2 * vr + (1 - self.beta2) * torch.mean(g2, dim=-1)
            nvc = self.beta2 * vc + (1 - self.beta2) * torch.mean(g2, dim=-2)
            return nvr, nvc
        return self.beta2 * vr + (1 - self.beta2) * g2, vc

    def _apply(self, nm, nvr, nvc, p, lr):
        """The update of ``p`` from its new f32 first moment and
        second-moment slots."""
        u = self._precondition(nm, nvr, nvc, p)
        # RMS update clipping (AdaFactor)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
        u = u + self.weight_decay * p.float()
        return (-lr * u).to(p.dtype)

    def _update_leaf(self, g, m, vr, vc, p, lr):
        g = g.float()
        nvr, nvc = self._new_v(g ** 2 + self.eps, vr, vc, p)
        # f32 math on the bf16-stored first moment (paper App. B)
        nm = self.beta1 * m.float() + (1 - self.beta1) * g
        return self._apply(nm, nvr, nvc, p, lr), nm.to(m.dtype), nvr, nvc

    @torch.no_grad()
    def update(self, grads, state: AdaFactorWState, params,
               lr: Union[float, torch.Tensor]):
        """One step: returns (updates, new state); ``lr`` is a float or a
        0-d tensor."""
        flat = tree_map(lambda g, m, vr, vc, p: self._update_leaf(
            g, m, vr, vc, p, lr), grads, state.m, state.v_row, state.v_col,
            params)
        updates, m, v_row, v_col = (_select(flat, i) for i in range(4))
        return updates, AdaFactorWState(step=state.step + 1, m=m,
                                        v_row=v_row, v_col=v_col)

    # -- paper §4.2: fold a microbatch gradient stream into the slots ------
    @torch.no_grad()
    def update_from_microbatches(self, c_stream, state: AdaFactorWState,
                                 params, lr: Union[float, torch.Tensor],
                                 var_hat=None):
        """One step from the Algorithm-1 'Yields' stream ``c_stream``
        (leaves (K, ...), ``core.gradaccum.microbatch_grads``): the exact
        K-step first moment, and the E[c²] − VarHat second moment (paper
        Eq. 4; ``var_hat`` a tree like the params, zeros by default).
        Returns (updates, new state); m is stored in bf16 afterwards when
        ``store_m_bf16``."""
        m32 = tree_map(lambda m: m.float(), state.m)
        nm = ma.accumulate_first_moment(m32, c_stream, self.beta1)

        def v_update(c, vr, vc, p, vh):
            g2 = torch.mean(c.float() ** 2, dim=0) + self.eps
            g2 = torch.clamp(g2 - vh, min=self.eps)   # paper Eq. 4
            return self._new_v(g2, vr, vc, p)

        vh_tree = var_hat if var_hat is not None else tree_map(
            lambda p: torch.zeros((), dtype=torch.float32, device=p.device),
            params)
        flat = tree_map(v_update, c_stream, state.v_row, state.v_col,
                        params, vh_tree)
        v_row, v_col = _select(flat, 0), _select(flat, 1)

        updates = tree_map(lambda m, vr, vc, p: self._apply(
            m, vr, vc, p, lr), nm, v_row, v_col, params)
        mdt = torch.bfloat16 if self.store_m_bf16 else torch.float32
        return updates, AdaFactorWState(
            step=state.step + 1, m=tree_map(lambda x: x.to(mdt), nm),
            v_row=v_row, v_col=v_col)


def _select(flat, i: int):
    """Entry ``i`` of every tuple leaf of a tree of tuples."""
    if isinstance(flat, dict):
        return {k: _select(v, i) for k, v in flat.items()}
    if isinstance(flat, list):
        return [_select(v, i) for v in flat]
    return flat[i]


@torch.no_grad()
def apply_updates(params, updates):
    """params + updates, leaf by leaf (fresh tensors)."""
    return tree_map(lambda p, u: p + u, params, updates)
