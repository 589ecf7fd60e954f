"""Full-sequence GQA attention for the encoder towers (port of
``repro/models/attention.py:25-235``).

Supports grouped-query heads, qk-norm, causal / bidirectional /
sliding-window / key-padding masks and RoPE. The full-sequence path runs
through a backend registry, resolved per ArchConfig (``cfg.attn_impl``):

  naive    materialised scores (the paper-era baseline)
  chunked  query blocks, scores live only per block
  flash    the hand-written Hopper kernels, forward and backward
           (``kernels/flash_attention``); the reference's ``"pallas"``
           resolves to it
  auto     flash on the card, chunked on the CPU

The reference sends a ``pallas`` request to ``chunked`` on an accelerator
when ``head_dim % 128`` or ``seq % 8`` is non-zero, a TPU tiling rule that
would take both BASIC towers (head_dim 64, image sequence 196) off the
kernel. The Hopper kernel masks its ragged tail, so the port has no such
rule. The decode half of the reference module waits for a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L

NEG_INF = -1e30

# reference backend names that resolve to a port backend
ALIASES = {"pallas": "flash"}


def init_attn_params(cfg: ArchConfig, generator: torch.Generator, extra=(),
                     device=None) -> dict:
    """Attention projection (+ optional qk-norm) params for one block,
    with optional leading stack dims ``extra``."""
    hd = cfg.resolved_head_dim
    p = {
        "wq": L.dense_init(generator, cfg.d_model, cfg.n_heads * hd, extra,
                           device),
        "wk": L.dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd,
                           extra, device),
        "wv": L.dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd,
                           extra, device),
        "wo": L.dense_init(generator, cfg.n_heads * hd, cfg.d_model, extra,
                           device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*extra, hd), device=device)
        p["k_norm"] = torch.ones((*extra, hd), device=device)
    return p


def _project_qkv(p, cfg: ArchConfig, x, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.dense(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = L.dense(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = L.dense(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(cfg: ArchConfig, q_pos, k_pos):
    """(q_len, k_len) additive fp32 mask from absolute positions."""
    m = torch.zeros((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.float32,
                    device=q_pos.device)
    if cfg.causal:
        m = m.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
    if cfg.sliding_window is not None:
        m = m.masked_fill(q_pos[:, None] - k_pos[None, :]
                          >= cfg.sliding_window, NEG_INF)
    return m


def _key_bias(key_mask):
    """(b, t) bool / additive key-padding mask -> (b, 1, 1, 1, t) additive
    fp32."""
    return fa_ops.key_bias(key_mask)[:, None, None, None, :]


def _scores_softmax_v(q, k, v, mask, key_bias):
    """One block of materialised attention on grouped heads. q: (b, s, kv,
    group, hd); k/v: (b, t, kv, hd). Scores and their scale run in q's
    dtype, the mask and softmax in fp32, the weights are cast back."""
    hd = q.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) * (hd ** -0.5)
    scores = scores.float() + mask
    if key_bias is not None:
        scores = scores + key_bias
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v)


def _sdpa(q, k, v, mask, key_mask=None):
    """q: (b, s, h, hd); k/v: (b, t, kv, hd); mask: (s, t) additive;
    key_mask: optional (b, t) bool/additive padding mask."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    kb = None if key_mask is None else _key_bias(key_mask)
    out = _scores_softmax_v(q.reshape(b, s, kv, h // kv, hd), k, v, mask, kb)
    return out.reshape(b, s, h, hd)


def _sdpa_chunked(q, k, v, mask, block: int, key_mask=None):
    """Attention over query blocks of ``block`` rows: the scores exist only
    per block. ``s`` must be a multiple of ``block``."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    kb = None if key_mask is None else _key_bias(key_mask)
    outs = []
    for s0 in range(0, s, block):
        qi = q[:, s0:s0 + block].reshape(b, block, kv, h // kv, hd)
        outs.append(_scores_softmax_v(qi, k, v, mask[s0:s0 + block], kb)
                    .reshape(b, block, h, hd))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------


ATTN_BACKENDS = {}


def register_backend(name: str):
    """Decorator registering a full-sequence attention backend under
    ``name``. Backends take (q (b,s,h,hd), k/v (b,s,kv,hd)) plus keyword
    context and return (b,s,h,hd)."""
    def deco(fn):
        ATTN_BACKENDS[name] = fn
        return fn
    return deco


@register_backend("naive")
def _naive_backend(q, k, v, *, cfg, positions, key_mask, block):
    """Materialised-scores baseline."""
    mask = _mask(cfg, positions[0], positions[0])
    return _sdpa(q, k, v, mask, key_mask)


@register_backend("chunked")
def _chunked_backend(q, k, v, *, cfg, positions, key_mask, block):
    """Query-block attention; a ragged tail falls back to ``naive``."""
    s = q.shape[1]
    mask = _mask(cfg, positions[0], positions[0])
    if s % min(block, s) != 0:
        return _sdpa(q, k, v, mask, key_mask)
    return _sdpa_chunked(q, k, v, mask, min(block, s), key_mask)


@register_backend("flash")
def _flash_backend(q, k, v, *, cfg, positions, key_mask, block):
    """The hand-written flash-attention kernels: the forward, and the
    backward under autograd (their plain versions on a CPU tensor).
    Assumes positions are the standard arange, true for every encode
    call."""
    out = fa_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal, window=cfg.sliding_window, key_mask=key_mask)
    return out.transpose(1, 2)


def available_backends() -> tuple:
    """Registered full-sequence attention backend names."""
    return tuple(sorted(ATTN_BACKENDS))


def resolve_backend(impl: Optional[str], device: torch.device) -> str:
    """Resolve an ``attn_impl`` request to a registered backend name.

    'auto' (or None) picks 'flash' on the card and 'chunked' on the CPU;
    the reference's 'pallas' means 'flash'. An explicit 'flash' on a CUDA
    tensor always runs the kernel: there is no fallback."""
    if impl in (None, "auto"):
        impl = "flash" if device.type == "cuda" else "chunked"
    impl = ALIASES.get(impl, impl)
    if impl not in ATTN_BACKENDS:
        raise KeyError(f"unknown attention impl {impl!r}; have "
                       f"{available_backends()} + 'auto', 'pallas'")
    return impl


def attention(p, cfg: ArchConfig, x, positions, impl: Optional[str] = None,
              block: Optional[int] = None, key_mask=None):
    """Full-sequence attention (encode). x: (b, s, d).

    impl: backend name ('naive' | 'chunked' | 'flash' | 'pallas' | 'auto');
    None defers to ``cfg.attn_impl``. key_mask: optional (b, s) bool mask
    (True = real token) masking padded key positions."""
    b, s, _ = x.shape
    impl = resolve_backend(impl if impl is not None else cfg.attn_impl,
                           x.device)
    block = block if block is not None else cfg.attn_block
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = ATTN_BACKENDS[impl](q, k, v, cfg=cfg, positions=positions,
                              key_mask=key_mask, block=block)
    return L.dense(out.reshape(b, s, -1), p["wo"])
