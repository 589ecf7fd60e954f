"""BASIC dual encoder: image tower F and text tower G mapping into S^D
(port of ``repro/models/dual_encoder.py``).

Paper §3: F(x), G(y) live on the D-dimensional unit sphere; similarity
A = (X^T Y)/tau with a learnable temperature stored as ``log_tau``. Text
pooling is the mean over positions. The towers run in the precision
policy's compute dtype; the embedding projections and the unit norm land
in fp32 under the default policies. ``layout`` (``core.weight_sharding``)
is given when the params are this rank's parts of weights split over the
model axis: the towers gather theirs per block, and ``image/proj`` and
``text/proj`` are gathered on use; ``log_tau`` is never split. Under a
'tp' layout the towers compute with their parts (``core.tensor_parallel``)
and each rank projects onto its ``embed_dim`` columns, joined over the
model group before the unit norm.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.dual import DualEncoderConfig
from repro_torch.core import tensor_parallel as tp
from repro_torch.core import weight_sharding as ws
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


def _project(pol, h, proj, lay):
    """The unit-norm embedding of the pooled ``h`` through ``proj`` (its
    part under ``lay``): gathered on use, or under 'tp' with the columns
    split over ``embed_dim`` each rank's columns joined over the group
    before the norm of the whole row (a ``proj`` split over d is made
    whole)."""
    h = pol.project(h)
    axis = tp.split_axis(lay, 1)
    if axis is not None:
        z = tp.gather_from_model(L.dense(tp.copy_to_model(h, axis), proj),
                                 axis)
    else:
        z = L.dense(h, tp.resolve(proj, lay))
    return _norm(z.float())


def encode_image(cfg: DualEncoderConfig, params, images, *, precision=None,
                 remat_policy=None, layout=None):
    """images: dict with 'image' (b, H, W, C) raw pixels. Returns (b, D) on
    S^D, fp32. ``remat_policy`` (``core.remat``) wraps each block;
    ``layout`` gathers split weights on use."""
    pol = prec_lib.resolve(precision)
    h = tf.encode(cfg.image_tower, params["image"]["tower"], images,
                  precision=pol, remat_policy=remat_policy,
                  layout=ws.sub(layout, "image", "tower"))
    return _project(pol, h, params["image"]["proj"],
                    ws.sub(layout, "image", "proj"))


def encode_text(cfg: DualEncoderConfig, params, texts, *, precision=None,
                remat_policy=None, layout=None):
    """texts: dict with 'tokens' (b, s) and optional 'attn_mask' (b, s)
    bool, which masks padding inside attention and pooling. Returns (b, D)
    on S^D, fp32. ``remat_policy`` (``core.remat``) wraps each block;
    ``layout`` gathers split weights on use."""
    pol = prec_lib.resolve(precision)
    h = tf.encode(cfg.text_tower, params["text"]["tower"], texts,
                  precision=pol, remat_policy=remat_policy,
                  layout=ws.sub(layout, "text", "tower"))
    return _project(pol, h, params["text"]["proj"],
                    ws.sub(layout, "text", "proj"))


def temperature(params):
    """tau = exp(log_tau), the learnable similarity temperature."""
    return torch.exp(params["log_tau"])
