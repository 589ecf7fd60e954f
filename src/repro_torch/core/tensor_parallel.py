"""Megatron execution of the ``tp`` rule: each rank of the model axis
computes with its parts of the weights as they lie, and the activations,
not the weights, cross the model group.

The reference states ``tp`` as metadata (``repro/core/sharding.py``, its
``_tp_leaf_spec``) and leaves the collectives to XLA. The port states
them. The params are placed by ``core.sharding.params_specs(..., "tp")``
(a ``core.weight_sharding.Layout`` of mode 'tp', built by ``layout``):
q/k/v and FFN-in split their output dim, o and FFN-out their input dim,
the MoE experts their expert axis (or, when the experts do not divide,
their ff dim), the embedding and the LM head the vocab. The M ranks of a
model group run the same examples, and the models use five operators
over the group (``launch.mesh.Axis``, ``mesh.model``):

  ``copy_to_model``      identity forward; the backward all-reduces the
                         input's gradient (each rank's part of the work
                         gives a part of it)
  ``reduce_from_model``  all-reduce forward (the parts' partial sums);
                         identity backward
  ``gather_from_model``  all-gathers a column-split output along its last
                         dim; the backward keeps this rank's slice
  ``whole``              gathers a split leaf on use; the backward keeps
                         this rank's slice and never reduce-scatters
  ``gathered``           gathers a split leaf on use; the backward
                         reduce-scatters (sums the ranks' gradients)

so a transformer block is copy, column-split q/k/v (H/M query heads, KV/M
kv heads), row-split o, reduce; copy, column-split FFN-in, row-split
FFN-out, reduce: two all-reduces forward and two backward. ``whole`` is
for the leaves the rule splits that Megatron does not consume split: the
stacked norm scales (``ln1``/``ln2``, ``q_norm``/``k_norm``, split over d
by the largest-dim fallback), the vision frontend, and an embedding or a
head the rule splits over d. Their gradient is the same on the M ranks,
since the block's activations and their gradients are; ``_Gather``'s
reduce-scatter (``core.weight_sharding``) would count it M times. A
serving step's params are placed by ``serving``'s layout, which holds
those leaves whole, so a prefill or decode step gathers no weight.

The Mamba-2 mixer (``models.ssm.mamba_mixer``) is split by heads: z, x
and dt are this rank's H/M heads (``in_z``, ``in_x``, ``in_dt`` split on
their columns, ``A_log``, ``D``, ``dt_bias`` per head), ``out`` is
row-split, so a mixer is copy, its H/M heads, reduce: one all-reduce
forward and one backward. The scan needs B and C whole on every rank,
and the rule's even split of ``conv_w``'s d_inner + 2n channels does
not fall on a rank's x channels, so ``in_B``, ``in_C`` and ``conv_w``
are made whole by ``gathered``: each rank's heads give a part of their
gradient, which the backward sums over the group (``_Gather``'s
reduce-scatter) before it keeps the rank's slice.

Every split must fall on whole heads and kv groups: ``check`` refuses a
model whose heads (attention or SSD), kv heads, ff dim or state dim do
not divide by M.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import sharding as shd
from repro_torch.core import weight_sharding as ws
from repro_torch.tree import tree_map

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Slice(torch.autograd.Function):
    """The whole tensor from the model group's slices along ``dim`` (rank
    order); the backward keeps this rank's slice of the gradient, which
    is the same on every rank of the group."""

    @staticmethod
    def forward(ctx, part, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, part.shape[dim]
        return ws.gather_leaf(part, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.axis.index * ctx.n,
                         ctx.n).contiguous(), None, None)


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` as it is; its gradient is summed over the model group."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the model group; its gradient passes as it
    is."""
    return _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The model group's column slices of one output joined along the
    last dim."""
    return _Slice.apply(x, x.dim() - 1, axis)


def whole(part: torch.Tensor, dim: Optional[int], axis) -> torch.Tensor:
    """The whole leaf from its parts split along ``dim`` (``part`` itself
    when ``dim`` is None); the backward keeps this rank's part."""
    return part if dim is None else _Slice.apply(part, dim, axis)


def gathered(part: torch.Tensor, dim: Optional[int], axis) -> torch.Tensor:
    """The whole leaf from its parts split along ``dim`` (``part`` itself
    when ``dim`` is None) for a leaf whose gradient differs by rank: the
    backward sums the ranks' gradients over the group and keeps this
    rank's part (``weight_sharding._Gather``)."""
    return part if dim is None else ws._Gather.apply(part, dim, axis)


def active(layout: Optional[ws.Layout]) -> bool:
    """True when ``layout`` places parts that the models compute with as
    they lie (mode 'tp')."""
    return layout is not None and layout.mode == "tp"


def resolve(tree, layout: Optional[ws.Layout]):
    """``tree`` (a subtree of parts, or one part) with every split leaf
    made whole for use: under a 'tp' layout by ``whole`` (the backward
    keeps the slice, since the gradient is the same on the M ranks),
    under any other by ``weight_sharding.gather`` (the backward
    reduce-scatters the ranks' partial gradients); ``tree`` itself
    without a layout. The models make every leaf they do not consume
    split whole through this one function."""
    if not active(layout):
        return ws.gather(tree, layout)
    return tree_map(lambda x, d: whole(x, d, layout.axis), tree,
                    layout.dims)


def split_axis(layout: Optional[ws.Layout], dim: int):
    """The model axis when ``layout`` is a 'tp' layout of one leaf split
    on ``dim`` (the split a caller consumes as it lies), else None."""
    return layout.axis if active(layout) and layout.dims == dim else None


def _towers(cfg) -> tuple:
    return ((cfg.image_tower, cfg.text_tower) if hasattr(cfg, "image_tower")
            else (cfg,))


def _need(t, m: int, what: str, n: int) -> None:
    if n % m:
        raise ValueError(f"{t.name}: --sharding tp at model extent {m} needs "
                         f"{what} to divide by {m}")


def check(cfg, m: int) -> None:
    """Raise ValueError, naming the arch and ``m``, unless every split of
    ``cfg`` (an LM or a dual encoder) under ``tp`` at model extent ``m``
    falls on whole heads, kv groups and ff columns and, for a Mamba-2
    mixer, on whole SSD heads (so d_inner) and state dims."""
    if m == 1:
        return
    for t in _towers(cfg):
        if t.family in ("ssm", "hybrid"):       # d_inner is heads × p
            s = t.ssm
            heads = s.expand * t.d_model // s.head_dim
            _need(t, m, f"its {heads} SSD heads", heads)
            _need(t, m, f"its state dim {s.state_dim}", s.state_dim)
        if t.family == "ssm":
            continue
        if t.n_heads % m or t.n_kv_heads % m:
            raise ValueError(
                f"{t.name}: --sharding tp at model extent {m} needs whole "
                f"heads on every rank, but its {t.n_heads} query and "
                f"{t.n_kv_heads} kv heads do not both divide by {m}")
        _need(t, m, f"its d_ff {t.d_ff}", t.d_ff)


def layout(cfg, like, mesh) -> Optional[ws.Layout]:
    """The 'tp' layout of the params ``like`` (whole leaves or their
    ``meta`` stand-ins) of ``cfg`` on ``mesh``, after ``check``: each
    leaf's dim ``params_specs(..., 'tp')`` splits over the model axis.
    None with one model rank."""
    check(cfg, mesh.model_size)
    return ws.from_specs(shd.params_specs(like, mesh, "tp"), mesh, "tp")


def local_heads(cfg, m: int):
    """``cfg`` with this rank's H/M query and KV/M kv heads (the head dim
    kept), for the attention of a rank's q/k/v columns."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // m,
                               n_kv_heads=cfg.n_kv_heads // m,
                               head_dim=cfg.resolved_head_dim)


# the dim each leaf a block consumes split lies on, in one layer's view
_SPLIT = {("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1,
          ("attn", "wo"): 0, ("ffn", "wi"): 1, ("ffn", "wg"): 1,
          ("ffn", "wo"): 0, ("moe", "dense_wi"): 1, ("moe", "dense_wg"): 1,
          ("moe", "dense_wo"): 0, ("mamba", "in_z"): 1, ("mamba", "in_x"): 1,
          ("mamba", "in_dt"): 1, ("mamba", "out"): 0, ("mamba", "A_log"): 0,
          ("mamba", "D"): 0, ("mamba", "dt_bias"): 0}
# the mixer's leaves every rank needs whole, whose gradient each rank's
# heads give a part of (``gathered``)
_SUMMED = {("mamba", "in_B"), ("mamba", "in_C"), ("mamba", "conv_w")}
# MoE experts (E, d, f) / (E, f, d): the expert axis, or the ff dim
_EXPERT = {"wi": (0, 2), "wg": (0, 2), "wo": (0, 1)}


# the dim a vocab-split embedding and head are consumed split on
_VOCAB = {"embed": 0, "lm_head": 1}


def _megatron_dims(group: str, name: str):
    """The dims a block consumes its leaf ``group``/``name`` split on, or
    None for a leaf it uses whole (``block_params`` makes it whole)."""
    if group == "moe" and name in _EXPERT:
        return _EXPERT[name]
    return (_SPLIT[(group, name)],) if (group, name) in _SPLIT else None


def block_params(p: dict, lay: ws.Layout) -> dict:
    """One layer's params for Megatron execution: the leaves a block
    consumes split stay this rank's parts, the mixer's ``in_B``, ``in_C``
    and ``conv_w`` are made whole by ``gathered``, every other split leaf
    by ``whole`` (a leaf ``lay`` holds whole, as ``serving`` places them,
    is used as it is). Raises ValueError for a consumed leaf split on
    another dim (``check`` keeps the rule's splits on the Megatron
    ones)."""
    out = {}
    for group, sub in p.items():
        dims = lay.dims[group]
        if not isinstance(sub, dict):
            out[group] = whole(sub, dims, lay.axis)
            continue
        out[group] = {}
        for name, x in sub.items():
            d = dims[name]
            want = _megatron_dims(group, name)
            if (group, name) in _SUMMED:
                x = gathered(x, d, lay.axis)
            elif want is None:
                x = whole(x, d, lay.axis)
            elif d not in want:
                raise ValueError(f"{group}/{name}: split on dim {d}, not on "
                                 f"the Megatron dim {want}")
            out[group][name] = x
    return out


def _held_whole(dims):
    """``dims`` (a subtree of split dims) with every leaf None."""
    if isinstance(dims, dict):
        return {k: _held_whole(v) for k, v in dims.items()}
    if isinstance(dims, (list, tuple)):
        return type(dims)(_held_whole(v) for v in dims)
    return None


def serving(layout: Optional[ws.Layout]) -> Optional[ws.Layout]:
    """The layout a serving step's params are placed by under the 'tp'
    ``layout``: the leaves Megatron consumes split stay split as
    ``layout`` places them (a block's q/k/v, o, FFN, expert and mixer
    head leaves, a vocab-split embedding and head), and every other leaf
    is held whole (its dim None): the norm scales, the mixer's B, C and
    conv weights, the vision frontend. A training step makes those whole
    on use, a collective a leaf a layer at every step; a serving step's
    weights never change, so they are joined once, where they are placed,
    and a prefill or decode step gathers no weight. Any other layout is
    returned as it is (``basic_ws`` gathers each layer on use: that is
    its rule)."""
    if not active(layout):
        return layout
    dims = {}
    for key, d in layout.dims.items():
        if key == "blocks":
            dims[key] = type(d)(
                {g: ({n: None if _megatron_dims(g, n) is None else x
                      for n, x in sub.items()} if isinstance(sub, dict)
                     else None) for g, sub in block.items()}
                for block in d)
        else:
            dims[key] = d if d is not None and d == _VOCAB.get(key) \
                else _held_whole(d)
    return ws.Layout(dims, layout.axis, layout.mode)


def expert_share(cfg, lay: ws.Layout):
    """(first, count) of the experts this rank holds when the rule splits
    the expert axis (expert parallelism), else None (the ff dim is split:
    every rank computes every expert's columns)."""
    if lay.dims["wi"] != 0:
        return None
    count = cfg.moe.num_experts // lay.axis.size
    return lay.axis.index * count, count


def vocab_embed(part: torch.Tensor, layout: Optional[ws.Layout], tokens,
                dtype) -> torch.Tensor:
    """Embedding rows of ``tokens`` in ``dtype`` from this rank's part of
    the table: split on the vocab under 'tp', each rank looks up the rows
    it owns, zeroes the rest and the group sums them; otherwise from the
    table ``resolve`` makes whole."""
    tok = tokens.long()
    axis = split_axis(layout, 0)
    if axis is None:
        return resolve(part, layout)[tok].to(dtype)
    n = part.shape[0]
    t = tok - axis.index * n
    own = (t >= 0) & (t < n)
    rows = part[t.clamp(0, n - 1)].to(dtype)
    return reduce_from_model(rows.masked_fill(~own[..., None], 0), axis)


def vocab_xent(logits: torch.Tensor, targets: torch.Tensor, axis
               ) -> torch.Tensor:
    """Per-position cross-entropy from this rank's vocab slice of the
    logits (..., V/M) fp32, slices in rank order, without gathering the
    whole vocab: the max over the group, the group's sum of exps, the
    target's logit from its owner. Returns (...) fp32."""
    n = logits.shape[-1]
    m = axis.all_reduce(logits.detach().amax(-1), "max")
    z = logits - m[..., None]
    lse = torch.log(reduce_from_model(torch.exp(z).sum(-1), axis))
    t = targets.long() - axis.index * n
    own = (t >= 0) & (t < n)
    zt = torch.gather(z, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    return lse - reduce_from_model(zt.masked_fill(~own, 0.0), axis)
