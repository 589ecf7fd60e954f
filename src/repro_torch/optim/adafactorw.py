"""AdaFactorW (paper App. B): AdaFactor's factored second moment, AdamW's
decoupled weight decay, and a first moment stored in bf16 and used in f32
(port of ``repro/optim/adafactorw.py:1-115``).

The (init, update) style of the reference, on the port's dict trees:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr)
    params = apply_updates(params, updates)

or, in one pass that holds one leaf's update at a time and releases each
gradient once used (the trainers' steps), ``params, state =
opt.apply(grads, state, params, lr)``: the same numbers.

Second moments of matrices (ndim >= 2, both trailing dims >=
factored_threshold) are stored as row/column running means; smaller
tensors keep a full second moment. Updates are RMS-clipped, then the
decoupled weight decay is added. The clip's RMS is over the leaf as it is
given: a layer's experts cut to a share (``models.moe``) are clipped by
the share's RMS, not the whole layer's. Nothing is updated in place:
``update`` returns fresh trees, as the reference does.

``update_from_microbatches`` wires in ``core/moment_accum.py``: the
microbatch gradient stream is folded straight into the moment slots (paper
§4.2) without allocating the averaged gradient ḡ. (Factored second-moment
rows and columns are linear in g², so the E[c²] accumulation is exact for
them.)

Weight sharding (paper §5.1, ``core.weight_sharding``): given the params'
``layout``, ``update`` and ``update_from_microbatches`` take this rank's
parts of the split leaves and their slots, and every statistic is the
whole leaf's, as the reference's is: whether a leaf is factored follows
its whole shape, a row or column mean over a split dim and the RMS of the
update are summed over the model group. ``split_dims`` says how each slot
of a split leaf is cut: ``m`` (and the full second moment of a small leaf)
like the leaf, the factored rows and columns like the leaf's dims they
keep, whole where the split dim is the one they average over.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

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


def _factored(shape, threshold: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= threshold and \
        shape[-2] >= threshold


class _Part(NamedTuple):
    """A leaf's part on this rank: ``dim`` split over ``axis`` (the model
    axis, ``launch.mesh.Axis``)."""
    dim: int
    axis: object


def _whole_shape(x: torch.Tensor, part: Optional[_Part]) -> list:
    shape = list(x.shape)
    if part is not None:
        shape[part.dim] *= part.axis.size
    return shape


def _mean(x: torch.Tensor, dim: int, part: Optional[_Part]):
    """The whole leaf's mean over ``dim`` (negative) of ``x``, a part cut
    as ``part`` (None: ``x`` is whole)."""
    if part is None or part.dim != dim % x.dim():
        return torch.mean(x, dim=dim)
    return part.axis.all_reduce(torch.sum(x, dim=dim)) / (
        x.shape[dim] * part.axis.size)


def _mean_all(x: torch.Tensor, part: Optional[_Part]):
    """The whole leaf's mean of ``x``, a part cut as ``part``."""
    if part is None:
        return torch.mean(x)
    return part.axis.all_reduce(torch.sum(x)) / (x.numel() * part.axis.size)


def _row_part(part: Optional[_Part], nd: int) -> Optional[_Part]:
    """How a factored leaf's row slot (its shape less the last dim) is
    cut: whole when the leaf's last dim is the split one."""
    return None if part is None or part.dim == nd - 1 else part


def _parts(p, layout):
    """A ``_Part`` or None for every leaf of ``p`` under ``layout``."""
    if layout is None:
        return tree_map(lambda _: None, p)
    return tree_map(lambda _, d: None if d is None else _Part(d, layout.axis),
                    p, layout.dims)


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
            if _factored(p.shape, self.factored_threshold):
                return torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=p.device)
            return torch.zeros_like(p, dtype=torch.float32)

        def vcol(p):
            if _factored(p.shape, self.factored_threshold):
                return torch.zeros((*p.shape[:-2], p.shape[-1]),
                                   dtype=torch.float32, device=p.device)
            return torch.zeros((), dtype=torch.float32, device=p.device)

        device = tree_leaves(params)[0].device
        return AdaFactorWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
            v_row=tree_map(vrow, params), v_col=tree_map(vcol, params))

    def split_dims(self, params_like, layout) -> AdaFactorWState:
        """The split dim of every slot of ``init(params_like)`` (whole
        leaves, or their ``meta`` stand-ins) under the params' ``layout``
        (``core.weight_sharding``): an ``AdaFactorWState`` of dims trees,
        None for a whole slot (module docstring)."""
        def row(p, d):
            if d is not None and _factored(p.shape, self.factored_threshold):
                return None if d == p.dim() - 1 else d
            return d

        def col(p, d):
            if d is None or not _factored(p.shape, self.factored_threshold):
                return None
            return {p.dim() - 2: None, p.dim() - 1: p.dim() - 2}.get(d, d)

        return AdaFactorWState(
            step=None, m=layout.dims,
            v_row=tree_map(row, params_like, layout.dims),
            v_col=tree_map(col, params_like, layout.dims))

    # -- core update ------------------------------------------------------
    def _precondition(self, g, vr, vc, p, part=None):
        if _factored(_whole_shape(p, part), self.factored_threshold):
            r = vr[..., None]                               # (..., rows, 1)
            c = vc[..., None, :]                            # (..., 1, cols)
            mean_r = _mean(vr, -1, _row_part(part, p.dim()))[..., None,
                                                              None]
            denom = torch.sqrt(r * c / torch.clamp(mean_r, min=self.eps))
            return g / torch.clamp(denom, min=self.eps ** 0.5)
        return g / torch.sqrt(vr + self.eps)

    def _new_v(self, g2, vr, vc, p, part=None):
        """The second-moment slots after taking in ``g2`` (E[g²] + eps)."""
        if _factored(_whole_shape(p, part), self.factored_threshold):
            nvr = self.beta2 * vr + (1 - self.beta2) * _mean(g2, -1, part)
            nvc = self.beta2 * vc + (1 - self.beta2) * _mean(g2, -2, part)
            return nvr, nvc
        return self.beta2 * vr + (1 - self.beta2) * g2, vc

    def _apply(self, nm, nvr, nvc, p, lr, part=None):
        """The update of ``p`` from its new f32 first moment and
        second-moment slots."""
        u = self._precondition(nm, nvr, nvc, p, part)
        # RMS update clipping (AdaFactor)
        rms = torch.sqrt(_mean_all(u * u, part) + 1e-30)
        u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
        u = u + self.weight_decay * p.float()
        return (-lr * u).to(p.dtype)

    def _update_leaf(self, g, m, vr, vc, p, lr, part):
        g = g.float()
        nvr, nvc = self._new_v(g ** 2 + self.eps, vr, vc, p, part)
        # f32 math on the bf16-stored first moment (paper App. B)
        nm = self.beta1 * m.float() + (1 - self.beta1) * g
        return (self._apply(nm, nvr, nvc, p, lr, part), nm.to(m.dtype), nvr,
                nvc)

    @torch.no_grad()
    def update(self, grads, state: AdaFactorWState, params,
               lr: Union[float, torch.Tensor], layout=None):
        """One step: returns (updates, new state); ``lr`` is a float or a
        0-d tensor. ``layout``: the params' ``core.weight_sharding``
        layout when the leaves and slots are parts (module docstring)."""
        flat = tree_map(lambda g, m, vr, vc, p, part: self._update_leaf(
            g, m, vr, vc, p, lr, part), grads, state.m, state.v_row,
            state.v_col, params, _parts(params, layout))
        updates, m, v_row, v_col = (_select(flat, i) for i in range(4))
        return updates, AdaFactorWState(step=state.step + 1, m=m,
                                        v_row=v_row, v_col=v_col)

    @torch.no_grad()
    def apply(self, grads, state: AdaFactorWState, params,
              lr: Union[float, torch.Tensor], layout=None):
        """``update`` then ``apply_updates``, leaf by leaf: returns (new
        params, new state), bit for bit theirs. Each gradient leaf is
        released from ``grads`` (its entry set to None) once used, and each
        update is dropped once applied, so the step holds one leaf's update
        instead of a whole tree of updates beside the gradients (for
        BASIC-L at one model rank, 16.7 GB each in f32)."""
        def walk(g, m, vr, vc, p, part):
            if isinstance(g, (dict, list)):
                keys = list(g) if isinstance(g, dict) else range(len(g))
                out = {} if isinstance(g, dict) else [None] * len(g)
                for k in keys:
                    out[k] = walk(g[k], m[k], vr[k], vc[k], p[k], part[k])
                    g[k] = None
                return out
            u, nm, nvr, nvc = self._update_leaf(g, m, vr, vc, p, lr, part)
            return p + u, nm, nvr, nvc
        flat = walk(grads, state.m, state.v_row, state.v_col, params,
                    _parts(params, layout))
        new_params, m, v_row, v_col = (_select(flat, i) for i in range(4))
        return new_params, AdaFactorWState(step=state.step + 1, m=m,
                                           v_row=v_row, v_col=v_col)

    # -- paper §4.2: fold a microbatch gradient stream into the slots ------
    @torch.no_grad()
    def update_from_microbatches(self, c_stream, state: AdaFactorWState,
                                 params, lr: Union[float, torch.Tensor],
                                 var_hat=None, layout=None):
        """One step from the Algorithm-1 'Yields' stream ``c_stream``
        (leaves (K, ...), ``core.gradaccum.microbatch_grads``): the exact
        K-step first moment, and the E[c²] − VarHat second moment (paper
        Eq. 4; ``var_hat`` a tree like the params, zeros by default).
        Returns (updates, new state); m is stored in bf16 afterwards when
        ``store_m_bf16``. ``layout`` as in ``update``."""
        m32 = tree_map(lambda m: m.float(), state.m)
        nm = ma.accumulate_first_moment(m32, c_stream, self.beta1)

        def v_update(c, vr, vc, p, vh, part):
            g2 = torch.mean(c.float() ** 2, dim=0) + self.eps
            g2 = torch.clamp(g2 - vh, min=self.eps)   # paper Eq. 4
            return self._new_v(g2, vr, vc, p, part)

        vh_tree = var_hat if var_hat is not None else tree_map(
            lambda p: torch.zeros((), dtype=torch.float32, device=p.device),
            params)
        parts = _parts(params, layout)
        flat = tree_map(v_update, c_stream, state.v_row, state.v_col,
                        params, vh_tree, parts)
        v_row, v_col = _select(flat, 0), _select(flat, 1)

        updates = tree_map(lambda m, vr, vc, p, part: self._apply(
            m, vr, vc, p, lr, part), nm, v_row, v_col, params, parts)
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
