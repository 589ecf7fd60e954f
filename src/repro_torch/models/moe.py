"""Mixture-of-Experts FFN: top-k router and GShard-style capacity dispatch
(port of ``repro/models/moe.py``).

Two dispatch modes, as in the reference:

- ``capacity`` (default): the tokens are cut into groups, and each
  expert's bucket in a group holds at most C = max(k, round(k·group/E·cf))
  (token, choice) pairs (Python's ``round``: half to even), clamped to the
  group. A pair's place in its bucket is its rank among the group's pairs
  for that expert, counted token-major (token 0's choices, then token
  1's, ...); the pairs ranked C or later are dropped. The reference moves
  the tokens in and out of the buckets with one-hot einsums; here both are
  gathers over a flat (expert, slot) index, with a spare zero row that
  empty slots and dropped pairs point at. The routing, the places, which
  pairs are kept and so the result are the reference's.
- ``dense``: every expert computes every token and the top-k weights
  combine them. Exact, no drops, E times the FLOPs.

Top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
does (``torch.topk`` does not): a stable descending sort, cut to k. A
zeroed router ties every probability, and bf16 router logits tie often.

Arctic's dense residual FFN (``dense_residual``) is added to the MoE
output. Expert products are ``torch.bmm`` over the expert axis; the
reference computes its MoE outside any Pallas kernel.

The expert share, ``experts=(first, count)``: the layer holds experts
first .. first + count - 1 of ``num_experts`` (their ``wi``, ``wg``,
``wo``; the expert axis has ``count`` entries), as one card of an
expert-parallel deployment does. The router keeps its published width and
picks the top-k over all experts; the bucket places and the capacity are
counted over all of them; only the held experts' buckets are computed,
and the combine sums only their part. The load-balance term and the dense
residual are the whole layer's, as every card computes them. The sum of
the shares' expert parts is the whole layer's; the reference's
counterpart is its expert-parallel layout (``repro/core/sharding.py:116-119``,
the expert axis over the ``model`` mesh axis), where each device's part
before the combine's reduction is its share's. ``None`` (the default)
holds every expert and computes what the layer computes without a share.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tensor_parallel as tp
from repro_torch.models import layers as L


def held_experts(cfg: ArchConfig, experts=None):
    """(first, count) of the share ``experts`` (None: every expert);
    raises ``ValueError`` unless 0 <= first and 1 <= count and first +
    count <= num_experts."""
    E = cfg.moe.num_experts
    if experts is None:
        return 0, E
    first, count = (int(v) for v in experts)
    if first < 0 or count < 1 or first + count > E:
        raise ValueError(f"{cfg.name}: expert share (first {first}, count "
                         f"{count}) is not within its {E} experts")
    return first, count


def init_moe_params(cfg: ArchConfig, generator: torch.Generator, extra=(),
                    device=None, experts=None) -> dict:
    """Router (…, d, E), experts ``wi``/``wg`` (…, E, d, f) and ``wo``
    (…, E, f, d), plus ``dense_wi``/``dense_wg``/``dense_wo`` for a dense
    residual; the reference's leaves and init law, ``extra`` stack axes
    first. With ``experts`` = (first, count) only those experts are drawn:
    the expert axis has ``count`` entries."""
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.num_experts
    _, count = held_experts(cfg, experts)
    p = {
        "router": L.dense_init(generator, d, E, extra, device),
        "wi": L.dense_init(generator, d, f, (*extra, count), device),
        "wg": L.dense_init(generator, d, f, (*extra, count), device),
        "wo": L.dense_init(generator, f, d, (*extra, count), device),
    }
    if m.dense_residual:
        p["dense_wi"] = L.dense_init(generator, d, f, extra, device)
        p["dense_wg"] = L.dense_init(generator, d, f, extra, device)
        p["dense_wo"] = L.dense_init(generator, f, d, extra, device)
    return p


def top_k_lower_index(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties broken
    toward the lower index, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, cfg: ArchConfig, x):
    """(top_p renormalised over the k picks, top_idx, the load-balance aux
    term) for x (..., d): logits in x's dtype, softmax in fp32."""
    m = cfg.moe
    logits = L.dense(x, p["router"])
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_idx = top_k_lower_index(probs, m.top_k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    # E · Σ_e (share of the picks that went to e) · (mean probability of e)
    picks = torch.nn.functional.one_hot(top_idx, m.num_experts).to(
        probs.dtype).sum(-2).reshape(-1, m.num_experts)
    f = picks.mean(0)
    pbar = probs.reshape(-1, m.num_experts).mean(0)
    aux = m.load_balance_coef * m.num_experts * torch.sum(f / m.top_k * pbar)
    return top_p, top_idx, aux


def _experts(p, xe):
    """Each expert's SwiGLU over its own rows: xe (E, rows, d) -> (E, rows,
    d), one batched product per weight, cast to xe's dtype."""
    dt = xe.dtype
    h = torch.bmm(xe, p["wi"].to(dt))
    g = torch.bmm(xe, p["wg"].to(dt))
    return torch.bmm(h * torch.nn.functional.silu(g), p["wo"].to(dt))


def _dense_dispatch(p, cfg: ArchConfig, x, top_p, top_idx, first: int,
                    count: int):
    """Every held expert on every token, combined with the top-k
    weights."""
    E = cfg.moe.num_experts
    b, s, d = x.shape
    combine = torch.zeros((b, s, E), dtype=x.dtype, device=x.device)
    combine.scatter_(-1, top_idx, top_p.to(x.dtype))
    eout = _experts(p, x.reshape(1, b * s, d).expand(count, -1, -1))
    return torch.einsum("end,ne->nd", eout, combine.reshape(b * s, E)[
        :, first:first + count]).reshape(b, s, d)


def capacity(k: int, group: int, num_experts: int,
             capacity_factor: float) -> int:
    """Bucket size per expert and group: max(k, round(k·group/E·cf)) with
    Python's round (half to even), at most the group."""
    cap = int(max(k, round(k * group / num_experts * capacity_factor)))
    return min(cap, group)


def bucket_positions(top_idx: torch.Tensor, num_experts: int, cap: int):
    """(pos, keep) for top_idx (n, g, k): each (token, choice) pair's place
    in its expert's bucket, its rank among the group's pairs for that
    expert counted token-major, and whether it fits (pos < cap)."""
    n, g, k = top_idx.shape
    flat = top_idx.reshape(n, g * k)
    onehot = torch.nn.functional.one_hot(flat, num_experts)
    ranks = torch.cumsum(onehot, dim=1) - 1
    pos = torch.gather(ranks, 2, flat[..., None])[..., 0].reshape(n, g, k)
    return pos, pos < cap


def _capacity_dispatch(p, cfg: ArchConfig, x, top_p, top_idx, group: int,
                       capacity_factor: float, first: int, count: int):
    """GShard capacity dispatch over groups of ``group`` tokens, the
    buckets of experts first .. first + count - 1 computed; x (b, s,
    d)."""
    m = cfg.moe
    b, s, d = x.shape
    E, k = m.num_experts, m.top_k
    if (b * s) % group:
        raise ValueError(f"capacity dispatch: {b}·{s} tokens are not a "
                         f"whole number of groups of {group}")
    n = b * s // group
    cap = capacity(k, group, E, capacity_factor)
    ti = top_idx.reshape(n, group, k)
    pos, keep = bucket_positions(ti, E, cap)
    # the held buckets' slots; pairs dropped or routed to an expert not
    # held point at the spare zero row
    held = keep & (ti >= first) & (ti < first + count)
    spare = count * cap
    slot = torch.where(held, (ti - first) * cap + pos, spare).reshape(
        n, group * k)
    # the token that fills each (expert, slot); the spare row past the group
    token = torch.arange(group, device=x.device).repeat_interleave(k)
    src = torch.full((n, spare + 1), group, dtype=torch.long,
                     device=x.device)
    src.scatter_(1, slot, token.expand(n, -1))
    xg = torch.cat([x.reshape(n, group, d),
                    x.new_zeros((n, 1, d))], dim=1)            # (n, g+1, d)
    xe = torch.gather(xg, 1, src[:, :spare, None].expand(-1, -1, d))
    # expert-major rows, so each weight is read once for all the groups
    xe = xe.reshape(n, count, cap, d).transpose(0, 1).reshape(
        count, n * cap, d)
    eout = _experts(p, xe).reshape(count, n, cap, d).transpose(0, 1)
    eout = torch.cat([eout.reshape(n, spare, d),
                      eout.new_zeros((n, 1, d))], dim=1)
    picked = torch.gather(eout, 1, slot[..., None].expand(-1, -1, d))
    w = torch.where(keep, top_p.reshape(n, group, k), 0.0).to(x.dtype)
    out = torch.einsum("ngk,ngkd->ngd", w, picked.reshape(n, group, k, d))
    return out.reshape(b, s, d)


def moe_ffn(p, cfg: ArchConfig, x, *, dispatch: str = "capacity",
            group: int = 4096, capacity_factor: float = 1.25, experts=None,
            axis=None):
    """x (b, s, d) -> (out (b, s, d), the load-balance aux scalar, fp32).
    ``dispatch``: 'capacity' (groups of min(group, b·s) tokens) or
    'dense'. ``experts`` = (first, count): the share the weights hold
    (None: every expert); ``ValueError`` when their expert axis is not
    ``count`` long or the share is not within the layer's experts.

    With the model ``axis`` (``core.tensor_parallel``) the experts, and
    the dense residual, are this rank's parts: its share of the experts
    (expert parallelism) or, with ``experts`` None, every expert's ff
    columns; the router is whole and every rank routes every token. The
    input and the combine weights enter the experts through
    ``copy_to_model`` (each rank's experts give a part of their
    gradients) and the ranks' partial outputs are summed. The aux term,
    from the whole router, is the same on every rank."""
    first, count = held_experts(cfg, experts)
    for name in ("wi", "wg", "wo"):
        if p[name].shape[-3] != count:
            raise ValueError(f"{cfg.name}: {name} holds "
                             f"{p[name].shape[-3]} experts, the share "
                             f"{count}")
    top_p, top_idx, aux = _router(p, cfg, x)
    if axis is not None:
        x, top_p = tp.copy_to_model(x, axis), tp.copy_to_model(top_p, axis)
    if dispatch == "dense":
        out = _dense_dispatch(p, cfg, x, top_p, top_idx, first, count)
    elif dispatch == "capacity":
        g = min(group, x.shape[0] * x.shape[1])
        out = _capacity_dispatch(p, cfg, x, top_p, top_idx, g,
                                 capacity_factor, first, count)
    else:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}; have "
                         f"'capacity', 'dense'")
    if cfg.moe.dense_residual:
        out = out + L.swiglu(x, p["dense_wi"], p["dense_wg"], p["dense_wo"])
    if axis is not None:
        out = tp.reduce_from_model(out, axis)
    return out, aux
