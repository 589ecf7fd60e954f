"""Dual-encoder (BASIC) config: an image tower, a text tower and the shared
embedding width (copy of ``repro/configs/dual.py``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, smoke_variant


@dataclasses.dataclass(frozen=True)
class DualEncoderConfig:
    """Image tower + text tower mapping into a D-dimensional unit sphere,
    with a learnable log-temperature initialised at ``init_temperature``."""
    name: str
    image_tower: ArchConfig
    text_tower: ArchConfig
    embed_dim: int
    init_temperature: float = 0.07
    text_pool: str = "mean"
    image_pool: str = "mean"
    source: str = "arXiv:2111.10050"


def _tower(name, L, d, H, dff, vocab, frontend=None, frontend_len=0,
           head_dim=None, image_size=0, patch_size=0) -> ArchConfig:
    return ArchConfig(
        name=name, family="encoder", n_layers=L, d_model=d, n_heads=H,
        n_kv_heads=H, d_ff=dff, vocab=vocab, causal=False, frontend=frontend,
        frontend_len=frontend_len, head_dim=head_dim, rope_theta=1e4,
        image_size=image_size, patch_size=patch_size,
        source="arXiv:2111.10050",
    )


def smoke_dual_variant(cfg: DualEncoderConfig,
                       embed_dim: int = 32) -> DualEncoderConfig:
    """CPU-sized variant: both towers shrunk by ``smoke_variant`` and the
    shared embedding width reduced."""
    return dataclasses.replace(
        cfg, image_tower=smoke_variant(cfg.image_tower),
        text_tower=smoke_variant(cfg.text_tower), embed_dim=embed_dim)
