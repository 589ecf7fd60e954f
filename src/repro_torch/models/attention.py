"""GQA attention: full-sequence (encode and prefill) and single-token
decode over a KV cache (port of ``repro/models/attention.py``).

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
rule.

Decode keeps two cache layouts, as the reference does: a linear cache
``k/v (batch, kv_heads, S, head_dim)`` written at ``pos``, and a ring
(sliding window, S = window) written at ``pos % S``. Its backends
(``resolve_decode_backend``) are ``einsum``, the reference's math, and
``decode``, the hand-written split-K kernel (``kernels/decode_attention``),
which ``pallas`` resolves to; the port has no TPU tiling fallback, so any
cache length and head dims 64 and 128 run on the kernel. Unlike the
reference, which rewrites the whole cache through ``jnp.where`` at every
step and donates the old one, the port writes the new k/v rows in place
with one indexed store per tensor and returns the same cache objects.

Under a model axis (``--sharding tp``, ``core.tensor_parallel``) a rank's
cache holds its KV/M kv heads: prefill gives the rank's k/v and decode
attends its H/M query heads over them, on the same kernels.

Over a sequence axis (``seq_axis``, the ranks ``launch.steps.cache_seq_axis``
places a cache's sequence over, as the reference's ``cache_specs`` does
for a cache longer than a head) rank r of P holds slots [r·T/P,
(r+1)·T/P) of the T slots: prefill builds that slice alone, decode writes
the new k/v only where its slot falls in the slice, attends over the
slice (the kernel's or the einsum's partial and its log-sum-exp) and
merges the ranks' partials (``merge_partials``). The reference gets the
same function from GSPMD, which partitions its softmax over the sharded
cache.

A linear cache longer than the window is a reference behaviour the port
reproduces: prefill honours the window, decode masks only ``idx <= pos``
and so attends past it (``repro/models/attention.py:356``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tensor_parallel as tp
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L

NEG_INF = -1e30

# reference backend names that resolve to a port backend
ALIASES = {"pallas": "flash"}


class KVCache(NamedTuple):
    """k/v: (batch, kv_heads, cache_len, head_dim), RoPE already applied.

    Whether the cache is a ring is derived, not stored (``is_ring``)."""
    k: torch.Tensor
    v: torch.Tensor


def is_ring(cfg: ArchConfig, cache_len: int) -> bool:
    """True when a cache of ``cache_len`` slots (the whole cache's, not a
    rank's slice of it) is ring-addressed: the arch slides a window and
    the length equals it."""
    return cfg.sliding_window is not None and cache_len == cfg.sliding_window


def kv_cache_len(cfg: ArchConfig, seq_len: int) -> int:
    """Slots of the decode cache ``init_kv_cache`` makes for ``seq_len``
    positions: the window when it fits (a ring), else ``seq_len``."""
    ring = cfg.sliding_window is not None and cfg.sliding_window <= seq_len
    return cfg.sliding_window if ring else seq_len


def _slice_of(seq_axis, cache_len: int):
    """(first slot, slots) of this rank's slice of a cache of
    ``cache_len`` slots split over ``seq_axis`` (None: the whole)."""
    if seq_axis is None or seq_axis.size == 1:
        return 0, cache_len
    if cache_len % seq_axis.size:
        raise ValueError(f"a cache of {cache_len} slots does not split over "
                         f"{seq_axis.size} ranks")
    n = cache_len // seq_axis.size
    return seq_axis.index * n, n


def _span(cache: KVCache, seq_axis):
    """(first slot, slots held, the whole cache's slots) of ``cache``, this
    rank's slice of a cache split over ``seq_axis`` (None: the whole)."""
    n = cache.k.shape[2]
    if seq_axis is None:
        return 0, n, n
    return seq_axis.index * n, n, n * seq_axis.size


def merge_partials(out, lse, axis):
    """The attention over a cache split over the ranks of ``axis`` (a
    ``launch.mesh.Axis``), from this rank's partial over its slice: out
    (b, h, d) and its fp32 log-sum-exp lse (b, h) (-1e30 and zeros where
    the slice has no valid key). One all-gather of the packed (b, h, d +
    1) fp32 partials, then in rank order: m = max lse, w_r = exp(lse_r −
    m), out = Σ w_r·out_r / Σ w_r. A row empty on every rank gives zeros.
    Every rank computes the same sum from the same gathered tensor, so
    every rank ends with the same bits. Returns (b, h, d) in out's
    dtype."""
    d = out.shape[-1]
    every = axis.all_gather(torch.cat([out.float(), lse[..., None].float()],
                                      dim=-1))
    lses = every[..., d]
    w = torch.exp(lses - lses.max(dim=0).values)
    num, den = every[0, ..., :d] * w[0, ..., None], w[0]
    for r in range(1, every.shape[0]):
        num = num + every[r, ..., :d] * w[r, ..., None]
        den = den + w[r]
    return (num / den[..., None]).to(out.dtype)


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


def attention(p, cfg: ArchConfig, x, positions, return_kv: bool = False,
              impl: Optional[str] = None, block: Optional[int] = None,
              key_mask=None, axis=None):
    """Full-sequence attention (encode and prefill). x: (b, s, d).

    impl: backend name ('naive' | 'chunked' | 'flash' | 'pallas' | 'auto');
    None defers to ``cfg.attn_impl``. key_mask: optional (b, s) bool mask
    (True = real token) masking padded key positions. With ``return_kv``
    also returns the RoPE'd (k, v), each (b, s, kv, hd). With the model
    ``axis`` (``core.tensor_parallel``) ``wq``/``wk``/``wv`` are this
    rank's column parts (its H/M query and KV/M kv heads) and ``wo`` its
    row part: the rank attends over its heads, and the input's gradient
    and the output are summed over the group; ``q_norm``/``k_norm``, shared
    by every head, have their gradients summed too. The (k, v) returned
    are then the rank's KV/M heads, from which ``cache_from_prefill``
    builds the rank's cache."""
    b, s, _ = x.shape
    impl = resolve_backend(impl if impl is not None else cfg.attn_impl,
                           x.device)
    block = block if block is not None else cfg.attn_block
    if axis is not None:
        cfg = tp.local_heads(cfg, axis.size)
        x = tp.copy_to_model(x, axis)
        p = {k: tp.copy_to_model(w, axis) if k in ("q_norm", "k_norm")
             else w for k, w in p.items()}
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = ATTN_BACKENDS[impl](q, k, v, cfg=cfg, positions=positions,
                              key_mask=key_mask, block=block)
    out = L.dense(out.reshape(b, s, -1), p["wo"])
    if axis is not None:
        out = tp.reduce_from_model(out, axis)
    if return_kv:
        return out, (k, v)
    return out


def cache_from_prefill(cfg: ArchConfig, k, v, cache_len: int,
                       dtype=None, seq_axis=None) -> KVCache:
    """A decode cache from prefill k/v ((b, s, kv, hd), RoPE applied).

    Linear cache: positions [0, min(s, cache_len)) at their own slots, the
    rest zeros. Ring (the window equals ``cache_len``) with s >= cache_len:
    the last ``cache_len`` positions at their ``pos % cache_len`` slots, so
    decode writes continue the ring. With ``seq_axis`` only this rank's
    slice of the slots is built (``_slice_of``): the whole cache is never
    allocated."""
    b, s, kvh, hd = k.shape
    dtype = dtype or k.dtype
    lo, n = _slice_of(seq_axis, cache_len)
    k = k.transpose(1, 2)                                 # (b, kv, s, hd)
    v = v.transpose(1, 2)
    if is_ring(cfg, cache_len) and s >= cache_len:
        src = np.arange(s - cache_len, s)                 # source positions
        order = src[np.argsort(src % cache_len)]          # slot i <- order[i]
        idx = torch.from_numpy(order[lo:lo + n]).to(k.device)
        return KVCache(k=k.index_select(2, idx).to(dtype),
                       v=v.index_select(2, idx).to(dtype))
    m = max(0, min(s, cache_len, lo + n) - lo)            # prompt slots held
    ck = torch.zeros((b, kvh, n, hd), dtype=dtype, device=k.device)
    cv = torch.zeros_like(ck)
    ck[:, :, :m] = k[:, :, lo:lo + m]
    cv[:, :, :m] = v[:, :, lo:lo + m]
    return KVCache(k=ck, v=cv)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, seq_len: int,
                  dtype=torch.bfloat16, *, device, seq_axis=None) -> KVCache:
    """Zeroed decode cache on ``device`` (required): ring-sized when the
    window fits in ``seq_len``, else ``seq_len`` long (``kv_cache_len``);
    with ``seq_axis`` this rank's slice of its slots."""
    hd = cfg.resolved_head_dim
    _, n = _slice_of(seq_axis, kv_cache_len(cfg, seq_len))
    shape = (batch, cfg.n_kv_heads, n, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


DECODE_BACKENDS = ("einsum", "decode")


def resolve_decode_backend(impl: Optional[str], device: torch.device) -> str:
    """Resolve an ``attn_impl`` request to a decode backend: 'einsum' (the
    reference's math) or 'decode' (the hand-written split-K kernel).

    'auto' (or None) picks 'decode' on the card and 'einsum' on the CPU.
    'pallas', and the port's own 'flash', mean the kernel path: 'decode'.
    'naive' and 'chunked' are full-sequence notions and map to 'einsum'.
    An explicit kernel request stays 'decode' at any cache length and head
    dim; there is no fallback. Anything else raises ``KeyError``."""
    if impl in (None, "auto"):
        return "decode" if device.type == "cuda" else "einsum"
    if impl in ("naive", "chunked", "einsum"):
        return "einsum"
    if impl in ("pallas", "flash", "decode"):
        return "decode"
    raise KeyError(f"unknown decode attention impl {impl!r}; have "
                   f"{DECODE_BACKENDS} + 'auto', 'pallas', 'naive', "
                   f"'chunked'")


def _write_cache(cfg: ArchConfig, cache: KVCache, k_new, v_new, pos,
                 per_slot: bool, seq_axis=None):
    """Write one token's k/v rows ((b, kv, hd)) into ``cache`` in place:
    slot ``pos % clen`` on a ring, else ``pos``. Past the end of a linear
    cache the reference's semantics hold: a scalar position clamps to the
    last slot (``dynamic_update_slice``), a per-slot one writes nothing.
    With ``seq_axis`` ``cache`` is this rank's slice of a cache of
    ``clen`` = its length × the axis's size, addressed as that whole
    cache, and a row is written only where its slot falls in the slice."""
    lo, n, clen = _span(cache, seq_axis)
    ring = is_ring(cfg, clen)
    kn = k_new.to(cache.k.dtype)
    vn = v_new.to(cache.v.dtype)
    if not per_slot:
        slot = pos % clen if ring else min(pos, clen - 1)
        if lo <= slot < lo + n:
            cache.k[:, :, slot - lo] = kn
            cache.v[:, :, slot - lo] = vn
        return
    rows = torch.arange(pos.shape[0], device=pos.device)
    slot = pos % clen if ring else pos.clamp(max=clen - 1)
    inside = None if ring else pos < clen
    if n < clen:
        mine = (slot >= lo) & (slot < lo + n)
        inside = mine if inside is None else inside & mine
        slot = (slot - lo).clamp(0, n - 1)
    if inside is not None:
        inside = inside[:, None, None]
        kn = torch.where(inside, kn, cache.k[rows, :, slot])
        vn = torch.where(inside, vn, cache.v[rows, :, slot])
    cache.k[rows, :, slot] = kn
    cache.v[rows, :, slot] = vn


def decode_attention(p, cfg: ArchConfig, x, cache: KVCache, pos,
                     impl: Optional[str] = None, axis=None, seq_axis=None):
    """One-token decode. x: (b, 1, d); pos: an int (every row at one
    position, the lockstep engine) or a (b,) integer tensor of per-slot
    positions (the continuous engine: write, RoPE and length mask per
    row; entries past a slot's position weigh exactly 0).

    The new k/v rows are written into ``cache`` in place, and the same
    cache comes back: returns (out (b, 1, d), cache). ``impl``: decode
    backend ('einsum' | 'decode' | 'pallas' | 'auto' | ...); None defers
    to ``cfg.attn_impl`` through ``resolve_decode_backend``. With the
    model ``axis`` (``core.tensor_parallel``) ``wq``/``wk``/``wv`` are
    this rank's column parts and ``wo`` its row part, as in
    ``attention``: ``cache`` holds the rank's KV/M kv heads, the rank
    attends its H/M query heads over them (the group count unchanged),
    and the output is summed over the group. With ``seq_axis`` ``cache``
    is this rank's slice of the sequence (``_write_cache``): the mask
    covers the slice's global slots, the kernel (or the einsum) gives the
    slice's partial and log-sum-exp, and ``merge_partials`` joins the
    ranks' partials before ``wo``."""
    b = x.shape[0]
    if axis is not None:
        cfg = tp.local_heads(cfg, axis.size)
        x = tp.copy_to_model(x, axis)
    hd = cfg.resolved_head_dim
    per_slot = torch.is_tensor(pos) and pos.dim() == 1
    if per_slot:
        pos = pos.to(device=x.device, dtype=torch.long)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((b, 1), pos, dtype=torch.long,
                               device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    _write_cache(cfg, cache, k_new[:, 0], v_new[:, 0], pos, per_slot,
                 seq_axis)

    lo, n, clen = _span(cache, seq_axis)
    split = n < clen
    ring = is_ring(cfg, clen)
    idx = torch.arange(lo, lo + n, device=x.device)
    if per_slot:
        valid = idx[None, :] <= pos[:, None]                # (b, n)
        if ring:
            # once pos >= clen the ring is full: every slot is in-window
            valid = valid | (pos >= clen)[:, None]
    else:
        valid = idx <= pos                                  # (n,)
        if ring and pos >= clen:
            valid = torch.ones_like(valid)

    impl = resolve_decode_backend(
        impl if impl is not None else cfg.attn_impl, x.device)
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if impl == "decode" and split:
        out, lse = dec_ops.decode_attention(q.reshape(b, h, hd), cache.k,
                                            cache.v, valid, return_lse=True)
    elif impl == "decode":
        out = dec_ops.decode_attention(q.reshape(b, h, hd), cache.k,
                                       cache.v, valid)
    else:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=x.device)
        mask = torch.where(valid, zero, neg)
        mask = mask[:, None, None, :] if per_slot else mask
        qh = q.reshape(b, kv, h // kv, hd)
        scores = torch.einsum("bkgd,bktd->bkgt", qh,
                              cache.k.to(qh.dtype)) * (hd ** -0.5)
        scores = scores.float() + mask
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgt,bktd->bkgd", w, cache.v.to(w.dtype))
        if split:
            # a slice with no valid key: zeros and -1e30, as the kernel
            live = valid.any(dim=-1)
            live = live[:, None, None] if per_slot else live
            lse = torch.where(live, torch.logsumexp(scores, dim=-1), neg)
            out = torch.where(live[..., None], out, zero.to(out.dtype))
    if split:
        out = merge_partials(out.reshape(b, h, hd), lse.reshape(b, h),
                             seq_axis)
    out = L.dense(out.reshape(b, 1, h * hd), p["wo"])
    if axis is not None:
        out = tp.reduce_from_model(out, axis)
    return out, cache
