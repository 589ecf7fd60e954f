"""Mamba-2 (SSD, state-space duality) mixer block [arXiv:2405.21060] (port
of ``repro/models/ssm.py``).

The full-sequence mixer splits its projections (z, x, B, C, dt), runs a
causal depthwise conv over (x, B, C), then the SSD scan through
``kernels.ssd_scan.ssd_scan``: the hand-written kernel on the card, the
chunked plain version (``ssd_chunked``, the reference's jnp algorithm) on
the CPU. The scan adds ``D·x`` itself, so the mixer does not add it again
as the reference does after its ``ssd_chunked``.

Under a model axis (``--sharding tp``, ``core.tensor_parallel``) the
mixer runs on this rank's H/M heads: x enters through ``copy_to_model``,
z, x and dt come from the rank's columns of ``in_z``, ``in_x`` and
``in_dt``, B and C whole from the whole ``in_B`` and ``in_C``, the conv
runs on the rank's x channels and all of B and C with the matching
columns of the whole ``conv_w``, the scan on H/M heads with the rank's
``A_log``, ``D`` and ``dt_bias``, and the row-split ``out`` is summed
over the group by ``reduce_from_model``. Its cache is the rank's: its
heads' SSD state and the conv window of its x channels and all of B and
C; decode steps the same share.

Decode is the O(1) recurrent form in plain PyTorch on both devices (the
reference has no kernel there): the state (b, heads, head_dim, N) is
updated per token and a depthwise-conv window of width conv_width - 1
feeds the (x, B, C) convolution. Unlike the reference, which returns a new
cache, ``mamba_decode`` writes the new state and window into the cache it
is given, in place (a layer's slice of the stacked cache).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tensor_parallel as tp
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers as L


class SSMCache(NamedTuple):
    """Decode-time SSM state: the SSD state (b, heads, head_dim, N) fp32
    and the conv window (b, conv_width - 1, d_conv) in the compute dtype."""
    ssm: torch.Tensor
    conv: torch.Tensor


def dims(cfg: ArchConfig):
    """Derived SSD dimensions (d_inner, n_heads, d_conv) for the config."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    d_conv = d_in + 2 * s.state_dim
    return d_in, nheads, d_conv


def init_ssm_params(cfg: ArchConfig, generator: torch.Generator, extra=(),
                    device=None) -> dict:
    """Mamba-2 block params with the reference's init law: in/out
    projections, the conv (truncated normal, σ = conv_width^-1/2), dt_bias
    0, A_log = log(linspace(1, 16, heads)), D 1."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, nheads, d_conv = dims(cfg)
    return {
        "in_z": L.dense_init(generator, d, d_in, extra, device),
        "in_x": L.dense_init(generator, d, d_in, extra, device),
        "in_B": L.dense_init(generator, d, s.state_dim, extra, device),
        "in_C": L.dense_init(generator, d, s.state_dim, extra, device),
        "in_dt": L.dense_init(generator, d, nheads, extra, device),
        "conv_w": L.trunc_normal(generator, (*extra, s.conv_width, d_conv),
                                 s.conv_width ** -0.5, device),
        "dt_bias": torch.zeros((*extra, nheads), device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, device=device)
                           ).expand(*extra, nheads).contiguous(),
        "D": torch.ones((*extra, nheads), device=device),
        "out": L.dense_init(generator, d_in, d, extra, device),
    }


def _conv1d(xBC: torch.Tensor, w: torch.Tensor, state=None):
    """Causal depthwise conv in xBC's dtype. xBC: (b, l, c); w: (cw, c);
    state: (b, cw-1, c) previous inputs (decode) or None (zero padding).
    Returns (out (b, l, c), the last cw-1 inputs, the new window)."""
    cw = w.shape[0]
    if state is None:
        pad = torch.zeros((xBC.shape[0], cw - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = state.to(xBC.dtype)
    full = torch.cat([pad, xBC], dim=1)
    l = xBC.shape[1]
    wc = w.to(xBC.dtype)
    out = full[:, 0:l, :] * wc[0]
    for i in range(1, cw):
        out = out + full[:, i:i + l, :] * wc[i]
    return out, (full[:, -(cw - 1):, :] if cw > 1 else pad)


def _project(p, cfg: ArchConfig, x):
    """The split input projections and the conv's input: (z, xBC, dt fp32
    after softplus(· + dt_bias))."""
    z = L.dense(x, p["in_z"])
    xBC = torch.cat([L.dense(x, p["in_x"]), L.dense(x, p["in_B"]),
                     L.dense(x, p["in_C"])], dim=-1)
    dt = F.softplus(L.dense(x, p["in_dt"]).float() + p["dt_bias"])
    return z, xBC, dt


def _rank_split(p, cfg: ArchConfig, axis):
    """(d_inner, heads, conv weight) of this rank's share of the mixer
    under ``axis``: the rank's x channels of the whole ``conv_w`` and all
    of its B and C channels. Raises ValueError unless ``p`` holds the
    rank's parts of the head-split leaves and the whole B, C and conv."""
    s = cfg.ssm
    d_all, h_all, c_all = dims(cfg)
    m, r = axis.size, axis.index
    d_in, nheads = d_all // m, h_all // m
    want = {"in_z": d_in, "in_x": d_in, "in_dt": nheads, "A_log": nheads,
            "D": nheads, "dt_bias": nheads, "in_B": s.state_dim,
            "in_C": s.state_dim, "conv_w": c_all}
    for name, n in want.items():
        if p[name].shape[-1] != n:
            raise ValueError(f"{cfg.name}: the mixer on {m} model ranks "
                             f"wants {name}'s last dim {n}, got "
                             f"{tuple(p[name].shape)}")
    if p["out"].shape[0] != d_in:
        raise ValueError(f"{cfg.name}: the mixer on {m} model ranks wants "
                         f"out's rows {d_in}, got {tuple(p['out'].shape)}")
    w = p["conv_w"]
    return d_in, nheads, torch.cat([w[:, r * d_in:(r + 1) * d_in],
                                    w[:, d_all:]], dim=-1)


def mamba_mixer(p, cfg: ArchConfig, x, cache: SSMCache = None, axis=None):
    """Full-sequence Mamba-2 mixer. x: (b, l, d); ``cache`` (optional)
    gives the conv window and SSD state to start from. Returns (out
    (b, l, d), the new ``SSMCache``: final SSD state fp32, last conv
    window in x's dtype). l must be at most ``cfg.ssm.chunk`` or a
    multiple of it (``ValueError`` otherwise, from the scan).

    ``axis``: the model axis when ``p`` holds this rank's Megatron parts
    (``core.tensor_parallel.block_params``); the rank computes its H/M
    heads and the output is summed over the group. The returned cache is
    then the rank's (its heads' state, its conv channels); a ``cache``
    cannot be given."""
    s = cfg.ssm
    d_in, nheads, _ = dims(cfg)
    b, l, _ = x.shape
    w = p["conv_w"]
    if axis is not None:
        if cache is not None:
            raise ValueError(f"{cfg.name}: mamba_mixer on a model axis "
                             f"takes no cache")
        d_in, nheads, w = _rank_split(p, cfg, axis)
        x = tp.copy_to_model(x, axis)
    z, xBC, dt = _project(p, cfg, x)
    xBC, new_conv = _conv1d(xBC, w, None if cache is None else cache.conv)
    xBC = F.silu(xBC)
    xh = xBC[..., :d_in].reshape(b, l, nheads, s.head_dim)
    Bm = xBC[..., d_in:d_in + s.state_dim]
    Cm = xBC[..., d_in + s.state_dim:]
    A = -torch.exp(p["A_log"].float())
    y, final = ssd_scan(xh, dt, A, Bm, Cm, p["D"].float(), chunk=s.chunk,
                        init_state=None if cache is None else cache.ssm)
    y = y.reshape(b, l, d_in).to(x.dtype) * F.silu(z)
    out = L.dense(y, p["out"])
    if axis is not None:
        out = tp.reduce_from_model(out, axis)
    return out, SSMCache(ssm=final, conv=new_conv)


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, *,
                   device, model: int = 1) -> SSMCache:
    """Zeroed decode cache for one SSM block on ``device`` (required); at
    ``model`` > 1 one rank's under ``tp``: its H/M heads' state and the
    conv window of its d_inner/M x channels and all of B and C."""
    s = cfg.ssm
    d_in, nheads, _ = dims(cfg)
    return SSMCache(
        ssm=torch.zeros((batch, nheads // model, s.head_dim, s.state_dim),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, s.conv_width - 1,
                          d_in // model + 2 * s.state_dim), dtype=dtype,
                         device=device))


def mamba_decode(p, cfg: ArchConfig, x, cache: SSMCache, axis=None):
    """Single-token recurrent step. x: (b, 1, d). Writes the new SSD state
    and conv window into ``cache`` in place; returns (out (b, 1, d),
    cache). With the model ``axis`` the step runs on this rank's H/M
    heads as ``mamba_mixer`` does (``_rank_split``): ``cache`` is the
    rank's (``init_ssm_cache(..., model=M)``, or the one its prefill
    built), and the output is summed over the group."""
    s = cfg.ssm
    d_in, nheads, _ = dims(cfg)
    b = x.shape[0]
    w = p["conv_w"]
    if axis is not None:
        d_in, nheads, w = _rank_split(p, cfg, axis)
        x = tp.copy_to_model(x, axis)
    z, xBC, dt = _project(p, cfg, x)                              # dt (b,1,h)
    xBC, new_conv = _conv1d(xBC, w, cache.conv)
    xBC = F.silu(xBC)
    A = -torch.exp(p["A_log"].float())                            # (h,)
    dt0 = dt[:, 0, :]                                             # (b, h)
    xh = xBC[:, 0, :d_in].reshape(b, nheads, s.head_dim).float()
    Bm = xBC[:, 0, d_in:d_in + s.state_dim].float()
    Cm = xBC[:, 0, d_in + s.state_dim:].float()
    state = (cache.ssm * torch.exp(dt0 * A)[..., None, None]
             + (dt0[..., None] * xh)[..., None] * Bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, Cm)
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(b, 1, d_in).to(x.dtype) * F.silu(z)
    cache.ssm.copy_(state)
    cache.conv.copy_(new_conv)
    out = L.dense(y, p["out"])
    if axis is not None:
        out = tp.reduce_from_model(out, axis)
    return out, cache
