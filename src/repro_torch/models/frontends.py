"""Vision frontend and per-(arch, shape) inputs (port of
``repro/models/frontends.py``).

Raw ``(b, H, W, C)`` images are cut into non-overlapping ``patch_size``
windows and projected to ``d_model``: exactly a stride-``patch_size``
convolution, written as a reshape plus a matmul as in the reference (a
float32 ``conv2d`` would run in TF32 under cuDNN's defaults).

``train_inputs_spec`` (meta-device stand-ins, torch's ``eval_shape``) and
``synthetic_inputs`` (a concrete batch) derive every shape from the config
in the same arithmetic, so they agree leaf for leaf; ``synthetic_inputs``
makes the reference's ``np.random.Generator`` calls in the reference's
order, so one seed gives both packages the same batch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import layers as L


def init_vision_frontend(cfg: ArchConfig, generator: torch.Generator,
                         device=None) -> dict:
    """Patchify-projection parameters:
    {'patch_proj': (patch_size²·channels, d_model) fp32}."""
    pd = cfg.patch_size * cfg.patch_size * cfg.channels
    return {"patch_proj": L.dense_init(generator, pd, cfg.d_model,
                                       device=device)}


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(b, H, W, C) -> (b, P, patch_size²·C) non-overlapping patches,
    row-major over the patch grid."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def patch_embed(p: dict, cfg: ArchConfig, images: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Raw (b, H, W, C) images -> (b, frontend_len, d_model) patch
    embeddings in ``dtype``."""
    x = patchify(images, cfg.patch_size).to(dtype)
    if x.shape[1] != cfg.frontend_len:
        raise ValueError(f"images give {x.shape[1]} patches; the tower "
                         f"expects {cfg.frontend_len} ({cfg.image_size}px, "
                         f"{cfg.patch_size}px patches)")
    return L.dense(x, p["patch_proj"])


def train_inputs_spec(cfg: ArchConfig, shape: InputShape,
                      dtype=torch.bfloat16) -> dict:
    """Meta-device stand-ins for one train/prefill batch of ``shape``:
    tokens (b, s) int32; raw images for a vision tower, plus the text that
    fills the rest of the sequence for a vlm; frame embeddings, targets
    and a mask for an encoder."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    if cfg.frontend == "vision":
        img = sds((b, cfg.image_size, cfg.image_size, cfg.channels), dtype)
        if cfg.vocab > 0:            # vlm: patches + text filling the rest
            return {"image": img,
                    "tokens": sds((b, s - cfg.frontend_len), torch.int32)}
        return {"image": img}
    if cfg.family == "encoder":  # frame embeddings + masked targets
        return {"embeddings": sds((b, s, cfg.d_model), dtype),
                "targets": sds((b, s), torch.int32),
                "mask": sds((b, s), torch.bool)}
    return {"tokens": sds((b, s), torch.int32)}


def synthetic_inputs(cfg: ArchConfig, batch: int, seq: int,
                     rng: np.random.Generator, *, device,
                     dtype=torch.float32) -> dict:
    """A concrete batch matching ``train_inputs_spec`` leaf for leaf, drawn
    from ``rng`` as the reference draws it, on ``device`` (required)."""
    def put(a, dt):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dt)
    if cfg.frontend == "vision":
        img = put(rng.standard_normal(
            (batch, cfg.image_size, cfg.image_size, cfg.channels)), dtype)
        if cfg.vocab > 0:
            if seq <= cfg.frontend_len:
                raise ValueError(f"seq {seq} leaves no text after "
                                 f"{cfg.frontend_len} patches")
            return {"image": img, "tokens": put(rng.integers(
                0, cfg.vocab, (batch, seq - cfg.frontend_len)), torch.int32)}
        return {"image": img}
    if cfg.family == "encoder":
        return {"embeddings": put(
                    rng.standard_normal((batch, seq, cfg.d_model)), dtype),
                "targets": put(rng.integers(0, cfg.vocab, (batch, seq)),
                               torch.int32),
                "mask": put(rng.random((batch, seq)) < 0.3, torch.bool)}
    return {"tokens": put(rng.integers(0, cfg.vocab, (batch, seq)),
                          torch.int32)}
