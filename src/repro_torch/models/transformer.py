"""Model assembly for the encoder towers, the dense decoder LMs and the
attention-free SSM LMs (port of ``repro/models/transformer.py``, the
encoder, dense and ssm families).

Parameters keep the reference's layout: ``params["blocks"]`` is a list
with one entry per position of the layer period (one for both families),
each a dict whose leaves stack all layers on a leading axis, so a
reference checkpoint maps onto the port leaf for leaf. An attention block
is ``ln1`` + ``attn`` + ``ln2`` + ``ffn``; a Mamba-2 block (``family="ssm"``)
is ``ln1`` + ``mamba`` alone. Decode caches keep the same stacking:
``caches`` is a list with one ``KVCache`` whose k/v are (n_layers, batch,
kv_heads, cache_len, head_dim), or one ``SSMCache`` whose ssm is
(n_layers, batch, heads, head_dim, state) fp32 and conv (n_layers, batch,
conv_width - 1, d_conv). ``forward`` runs a Python loop over the layer
axis where the reference runs ``lax.scan``.

Entry points:
  init_params(cfg, generator, device)            -> params dict
  lm_loss(cfg, params, batch)                    -> (loss, metrics)
  encode(cfg, params, batch)                     -> pooled (b, d_model)
  prefill(cfg, params, batch, collect_cache_len) -> logits [, caches]
  decode_step(cfg, params, token, pos, caches)   -> (logits, caches)
  init_caches(cfg, batch, seq_len, device=...)   -> zeroed caches

``forward`` and ``encode`` take a ``remat_policy`` (``core.remat``) that
wraps each block in a checkpoint, as the reference wraps each period step
(``repro/models/transformer.py:168-169``). ``decode_step`` writes each
layer's new k/v (or SSD state and conv window) into the caches in place
and returns the same objects. The MoE, hybrid and vlm families wait for
their own slices; ``lm_loss`` of the encoder family (hubert's masked-frame
loss) waits for the audio slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import remat as remat_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import frontends as fe
from repro_torch.models import layers as L
from repro_torch.models import precision as prec_lib
from repro_torch.models import ssm as ssm_lib


# the slice of the port that brings each family it does not run yet
_LATER = {"moe": "the MoE slice",
          "hybrid": "the MoE slice, after the SSM family (Jamba needs MoE)",
          "vlm": "the MoE slice, with the vlm frontend"}


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("encoder", "dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the encoder, dense and ssm families; "
            f"{cfg.family!r} comes with "
            f"{_LATER.get(cfg.family, 'a later slice')}")


def period_of(cfg: ArchConfig) -> int:
    """Layer-stack period (the reference's scan unit): 1 for every family
    the port runs, whose blocks are all of one kind; the hybrid
    interleave and the MoE term come with their slices."""
    _check_family(cfg)
    return 1


def _init_block(cfg: ArchConfig, generator: torch.Generator, extra,
                device) -> dict:
    d = cfg.d_model
    if cfg.family == "ssm":         # Mamba-2 blocks have no separate FFN
        return {"ln1": torch.ones((*extra, d), device=device),
                "mamba": ssm_lib.init_ssm_params(cfg, generator, extra,
                                                 device)}
    return {
        "ln1": torch.ones((*extra, d), device=device),
        "attn": attn_lib.init_attn_params(cfg, generator, extra, device),
        "ln2": torch.ones((*extra, d), device=device),
        "ffn": {
            "wi": L.dense_init(generator, d, cfg.d_ff, extra, device),
            "wg": L.dense_init(generator, d, cfg.d_ff, extra, device),
            "wo": L.dense_init(generator, cfg.d_ff, d, extra, device),
        },
    }


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> dict:
    """Tower params: the stacked block list, final norm, the vision
    frontend and, for a token tower, the embedding table and LM head (the
    reference's leaves, drawn with its init law)."""
    period = period_of(cfg)
    params = {
        "blocks": [_init_block(cfg, generator, (cfg.n_layers // period,),
                               device) for _ in range(period)],
        "final_norm": torch.ones((cfg.d_model,), device=device),
    }
    if cfg.frontend == "vision":
        params["frontend"] = fe.init_vision_frontend(cfg, generator, device)
    if cfg.vocab > 0:
        params["embed"] = L.trunc_normal(generator, (cfg.vocab, cfg.d_model),
                                         cfg.d_model ** -0.5, device)
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                             cfg.vocab, device=device)
    return params


def _layer(tree, i: int):
    """Layer ``i`` of a dict of stacked leaves."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(cfg: ArchConfig, p, h, positions, key_mask=None,
                 cache=None, decode=False, collect_cache_len=None):
    """Pre-norm attention + SwiGLU block, or a pre-norm Mamba-2 block for
    the SSM family. Returns (h, the layer's cache: the one given, written
    in place, when decoding; one built from the prompt with
    ``collect_cache_len``; else None)."""
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    new_cache = None
    if cfg.family == "ssm":
        if decode:
            mix, new_cache = ssm_lib.mamba_decode(p["mamba"], cfg, hn, cache)
        else:
            mix, new_cache = ssm_lib.mamba_mixer(p["mamba"], cfg, hn)
        return h + mix, (new_cache if decode or collect_cache_len is not None
                         else None)
    if decode:
        mix, new_cache = attn_lib.decode_attention(p["attn"], cfg, hn, cache,
                                                   positions)
    elif collect_cache_len is not None:
        mix, (k, v) = attn_lib.attention(p["attn"], cfg, hn, positions,
                                         return_kv=True, key_mask=key_mask)
        new_cache = attn_lib.cache_from_prefill(cfg, k, v, collect_cache_len)
    else:
        mix = attn_lib.attention(p["attn"], cfg, hn, positions,
                                 key_mask=key_mask)
    h = h + mix
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + L.swiglu(hn, p["ffn"]["wi"], p["ffn"]["wg"],
                        p["ffn"]["wo"]), new_cache


def forward(cfg: ArchConfig, params, h, positions, key_mask=None,
            remat_policy=None, caches=None, decode=False,
            collect_cache_len=None):
    """Run the block stack. h: (b, s, d); key_mask: optional (b, s) bool
    padding mask threaded into attention; remat_policy: optional
    ``core.remat`` policy applied per block (not while decoding or
    building caches). ``decode``: one token per row against ``caches``
    at ``positions`` (an int or a (b,) tensor). ``collect_cache_len``:
    build decode caches of that length from the prompt.

    Returns (h, caches): the caches given (written in place), the ones
    built, or None."""
    _check_family(cfg)
    stack = params["blocks"][0]
    if decode:
        c = caches[0]
        for i in range(cfg.n_layers):
            h, _ = _apply_block(cfg, _layer(stack, i), h, positions,
                                cache=type(c)(*(x[i] for x in c)),
                                decode=True)
        return h, caches
    if collect_cache_len is not None:
        built = []
        for i in range(cfg.n_layers):
            h, c = _apply_block(cfg, _layer(stack, i), h, positions,
                                key_mask=key_mask,
                                collect_cache_len=collect_cache_len)
            built.append(c)
        return h, [type(built[0])(*(torch.stack(leaf)
                                    for leaf in zip(*built)))]

    def block(p, h, positions, key_mask):
        return _apply_block(cfg, p, h, positions, key_mask)[0]

    for i in range(cfg.n_layers):
        h = remat_lib.apply(remat_policy, block, _layer(stack, i), h,
                            positions, key_mask)
    return h, None


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def embed_inputs(cfg: ArchConfig, params, batch, dtype):
    """Returns (h (b, s, d), positions (b, s), text_mask (b, s) or None).

    Vision towers consume raw ``batch['image']`` (b, H, W, C) through the
    linear-patchify frontend; with ``batch['tokens']`` too, token
    embeddings follow the patches. Token towers embed ``batch['tokens']``."""
    if cfg.frontend == "vision" and "image" in batch:
        patches = fe.patch_embed(params["frontend"], cfg, batch["image"],
                                 dtype)
        b, p = patches.shape[:2]
        if cfg.vocab > 0 and "tokens" in batch:
            tok = batch["tokens"]
            emb = params["embed"][tok.long()].to(dtype)
            h = torch.cat([patches, emb], dim=1)
            text_mask = torch.cat(
                [torch.zeros((b, p), dtype=torch.bool, device=h.device),
                 torch.ones(tok.shape, dtype=torch.bool, device=h.device)],
                dim=1)
            return h, _positions(b, h.shape[1], h.device), text_mask
        return patches, _positions(b, p, patches.device), None
    tok = batch["tokens"]
    emb = params["embed"][tok.long()].to(dtype)
    b, s = tok.shape
    return emb, _positions(b, s, emb.device), None


def encode(cfg: ArchConfig, params, batch, *, precision=None,
           remat_policy=None):
    """Pooled representation of a dual-encoder tower: (b, d_model) in the
    policy's projection dtype (fp32 under the default policies).

    ``batch['attn_mask']`` (b, s) masks padded text positions both inside
    attention and in the mean pooling; pooling accumulates in fp32.
    ``remat_policy`` wraps each block (``forward``)."""
    pol = prec_lib.resolve(precision)
    h, pos, _ = embed_inputs(cfg, params, batch, pol.compute_dtype)
    mask = batch.get("attn_mask")
    h, _ = forward(cfg, params, h, pos, key_mask=mask,
                   remat_policy=remat_policy)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    h = pol.accum(h)
    if mask is not None:
        m = mask.to(h.dtype)[..., None]
        pooled = torch.sum(h * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                       min=1.0)
    else:
        pooled = torch.mean(h, dim=1)
    return pol.project(pooled)


# ---------------------------------------------------------------------------
# Decoder LMs: logits, the training loss, caches, prefill and decode
# ---------------------------------------------------------------------------


def logits_from_h(cfg: ArchConfig, params, h,
                  pol: prec_lib.Precision = None):
    """Vocabulary logits from hidden states (b, s, d): the tied head
    h @ embedᵀ, or ``lm_head``, in the policy's projection dtype (fp32
    under the default policies)."""
    if pol is not None:
        h = pol.project(h)
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"].to(h.dtype).T)
    return L.dense(h, params["lm_head"])


def lm_loss(cfg: ArchConfig, params, batch, *, dtype=torch.float32,
            precision=None, remat_policy=None):
    """Training loss of a decoder LM: next-token cross-entropy over
    ``batch['tokens']`` (b, s), averaged over the (b, s - 1) predicted
    positions, or over those ``batch['loss_mask'][:, 1:]`` keeps. The
    logits and the cross-entropy are fp32 whatever the compute dtype.
    ``precision`` (a policy or its name) wins over the legacy ``dtype``
    (default f32, as in the reference); ``remat_policy`` wraps each block.

    Returns (loss + aux, {'xent': loss, 'aux': aux}); aux, the MoE load
    balance term, is 0 for the families the port runs."""
    _check_family(cfg)
    if cfg.family == "encoder":
        raise NotImplementedError(
            f"{cfg.name}: the masked-frame loss of the encoder family comes "
            f"with the audio slice (hubert-xlarge)")
    pol = prec_lib.resolve(precision, dtype)
    h, pos, _ = embed_inputs(cfg, params, batch, pol.compute_dtype)
    h, _ = forward(cfg, params, h, pos, remat_policy=remat_policy)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_from_h(cfg, params, h, pol).float()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    tgt = batch["tokens"][:, 1:].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        m = mask[:, 1:].float()
        loss = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    else:
        loss = torch.mean(nll)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + aux, {"xent": loss, "aux": aux}


def init_caches(cfg: ArchConfig, batch: int, seq_len: int,
                dtype=torch.bfloat16, *, device) -> list:
    """Zeroed decode caches on ``device`` (required), stacked over the
    layers: a list with one ``KVCache`` of (n_layers, batch, kv_heads,
    cache_len, head_dim), ring-sized when the window fits in ``seq_len``,
    or for the SSM family one ``SSMCache`` of (n_layers, batch, ...),
    whatever ``seq_len``."""
    _check_family(cfg)
    if cfg.family == "ssm":
        one = ssm_lib.init_ssm_cache(cfg, batch, dtype, device=device)
    else:
        one = attn_lib.init_kv_cache(cfg, batch, seq_len, dtype,
                                     device=device)
    return [type(one)(*(x[None].expand(cfg.n_layers, *x.shape).contiguous()
                        for x in one))]


def prefill(cfg: ArchConfig, params, batch, *, dtype=torch.bfloat16,
            precision=None, collect_cache_len=None):
    """Forward over ``batch['tokens']`` (b, s) emitting the last position's
    logits (b, 1, vocab); with ``collect_cache_len`` also builds the decode
    caches (serving prefill) and returns (logits, caches). ``precision``
    (a policy or its name) wins over the legacy ``dtype``, whose default
    is bf16, as in the reference."""
    pol = prec_lib.resolve(precision, dtype)
    h, pos, _ = embed_inputs(cfg, params, batch, pol.compute_dtype)
    h, caches = forward(cfg, params, h, pos,
                        collect_cache_len=collect_cache_len)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_from_h(cfg, params, h[:, -1:, :], pol)
    if collect_cache_len is not None:
        return logits, caches
    return logits


def decode_step(cfg: ArchConfig, params, token, pos, caches, *,
                dtype=torch.bfloat16, precision=None):
    """One decode step. token: (b, 1) integer tensor; pos: an int (every
    row at one position, the lockstep engine) or a (b,) integer tensor of
    per-slot positions (the continuous engine; the SSM family ignores it).
    Writes each layer's new k/v, or SSD state and conv window, into
    ``caches`` in place; returns (logits (b, 1, vocab), caches)."""
    pol = prec_lib.resolve(precision, dtype)
    h = params["embed"][token.long()].to(pol.compute_dtype)
    h, caches = forward(cfg, params, h, pos, caches=caches, decode=True)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return logits_from_h(cfg, params, h, pol), caches
