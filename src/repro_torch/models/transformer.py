"""Encoder trunk of the BASIC towers (port of ``repro/models/transformer.py``,
the encoder family).

Parameters keep the reference's layout: ``params["blocks"]`` is a list
with one entry per position of the layer period (one for the encoder
towers), each a dict whose leaves stack all layers on a leading axis, so a
reference checkpoint maps onto the port leaf for leaf. ``forward`` runs a
Python loop over that axis where the reference runs ``lax.scan``.

Entry points:
  init_params(cfg, generator, device)  -> params dict
  encode(cfg, params, batch)           -> pooled (b, d_model)

``lm_loss``, ``prefill``, ``decode_step``, MoE and SSM blocks, and remat
wait for later slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import frontends as fe
from repro_torch.models import layers as L
from repro_torch.models import precision as prec_lib


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "encoder":
        raise NotImplementedError(
            f"{cfg.name}: the port runs the encoder family only, not "
            f"{cfg.family!r}")


def _init_block(cfg: ArchConfig, generator: torch.Generator, extra,
                device) -> dict:
    d = cfg.d_model
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
    _check_family(cfg)
    params = {
        "blocks": [_init_block(cfg, generator, (cfg.n_layers,), device)],
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


def _apply_block(cfg: ArchConfig, p, h, positions, key_mask=None):
    """Pre-norm attention + SwiGLU block."""
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h + attn_lib.attention(p["attn"], cfg, hn, positions,
                               key_mask=key_mask)
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + L.swiglu(hn, p["ffn"]["wi"], p["ffn"]["wg"], p["ffn"]["wo"])


def forward(cfg: ArchConfig, params, h, positions, key_mask=None):
    """Run the block stack. h: (b, s, d); key_mask: optional (b, s) bool
    padding mask threaded into attention. Returns h."""
    _check_family(cfg)
    stack = params["blocks"][0]
    for i in range(cfg.n_layers):
        h = _apply_block(cfg, _layer(stack, i), h, positions, key_mask)
    return h


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


def encode(cfg: ArchConfig, params, batch, *, precision=None):
    """Pooled representation of a dual-encoder tower: (b, d_model) in the
    policy's projection dtype (fp32 under the default policies).

    ``batch['attn_mask']`` (b, s) masks padded text positions both inside
    attention and in the mean pooling; pooling accumulates in fp32."""
    pol = prec_lib.resolve(precision)
    h, pos, _ = embed_inputs(cfg, params, batch, pol.compute_dtype)
    mask = batch.get("attn_mask")
    h = forward(cfg, params, h, pos, key_mask=mask)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    h = pol.accum(h)
    if mask is not None:
        m = mask.to(h.dtype)[..., None]
        pooled = torch.sum(h * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                       min=1.0)
    else:
        pooled = torch.mean(h, dim=1)
    return pol.project(pooled)
