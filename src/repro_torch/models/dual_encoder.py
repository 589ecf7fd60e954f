"""BASIC dual encoder: image tower F and text tower G mapping into S^D
(port of ``repro/models/dual_encoder.py``).

Paper §3: F(x), G(y) live on the D-dimensional unit sphere; similarity
A = (X^T Y)/tau with a learnable temperature stored as ``log_tau``. Text
pooling is the mean over positions. The towers run in the precision
policy's compute dtype; the embedding projections and the unit norm land
in fp32 under the default policies.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.dual import DualEncoderConfig
from repro_torch.models import layers as L
from repro_torch.models import precision as prec_lib
from repro_torch.models import transformer as tf


def init_params(cfg: DualEncoderConfig, generator: torch.Generator,
                device) -> dict:
    """Parameter dict with the reference's leaf paths: per-tower transformer
    params (the image tower's patchify frontend included), the embedding
    projections, and ``log_tau = log(init_temperature)``. Weights are drawn
    with the reference's law (truncated normal at ±2σ, σ = d_in^-0.5) from
    ``generator``; its bits differ from ``jax.random``'s."""
    image = tf.init_params(cfg.image_tower, generator, device)
    text = tf.init_params(cfg.text_tower, generator, device)
    return {
        "image": {
            "tower": image,
            "proj": L.dense_init(generator, cfg.image_tower.d_model,
                                 cfg.embed_dim, device=device),
        },
        "text": {
            "tower": text,
            "proj": L.dense_init(generator, cfg.text_tower.d_model,
                                 cfg.embed_dim, device=device),
        },
        "log_tau": torch.tensor(math.log(cfg.init_temperature),
                                dtype=torch.float32, device=device),
    }


def _norm(z):
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                           min=1e-6)


def encode_image(cfg: DualEncoderConfig, params, images, *, precision=None,
                 remat_policy=None):
    """images: dict with 'image' (b, H, W, C) raw pixels. Returns (b, D) on
    S^D, fp32. ``remat_policy`` (``core.remat``) wraps each block."""
    pol = prec_lib.resolve(precision)
    h = tf.encode(cfg.image_tower, params["image"]["tower"], images,
                  precision=pol, remat_policy=remat_policy)
    return _norm(L.dense(pol.project(h), params["image"]["proj"]).float())


def encode_text(cfg: DualEncoderConfig, params, texts, *, precision=None,
                remat_policy=None):
    """texts: dict with 'tokens' (b, s) and optional 'attn_mask' (b, s)
    bool, which masks padding inside attention and pooling. Returns (b, D)
    on S^D, fp32. ``remat_policy`` (``core.remat``) wraps each block."""
    pol = prec_lib.resolve(precision)
    h = tf.encode(cfg.text_tower, params["text"]["tower"], texts,
                  precision=pol, remat_policy=remat_policy)
    return _norm(L.dense(pol.project(h), params["text"]["proj"]).float())


def temperature(params):
    """tau = exp(log_tau), the learnable similarity temperature."""
    return torch.exp(params["log_tau"])
