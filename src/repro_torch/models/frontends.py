"""Vision frontend: linear patchify of raw images (port of
``repro/models/frontends.py:28-52``).

Raw ``(b, H, W, C)`` images are cut into non-overlapping ``patch_size``
windows and projected to ``d_model``: exactly a stride-``patch_size``
convolution, written as a reshape plus a matmul as in the reference (a
float32 ``conv2d`` would run in TF32 under cuDNN's defaults).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
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
