"""Architecture config and registry (copy of ``repro/configs/base.py``,
covering the encoder towers of the BASIC dual encoders and the dense
decoder LMs).

Every config is a frozen dataclass built in its own ``configs/<id>.py``
module and registered here when ``get_arch`` first runs. The dense LMs
(Llama-3.2-1B, Qwen3-32B, Minitron-4B, InternLM2-20B) serve through the
decode engines; the MoE, SSM, hybrid, vlm and audio configs and their
``moe``/``ssm``/``attn_every`` fields wait for later slices of the port.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One transformer tower: widths, masks, attention backend, and the
    vision frontend's geometry (field meanings as in the reference)."""
    name: str
    family: str                   # 'encoder' (BASIC towers) | 'dense' (LMs)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # tokens; None = full attention
    causal: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    # attention backend (models.attention registry): 'naive', 'chunked',
    # 'flash' (the hand-written kernel; the reference's 'pallas' maps to
    # it) or 'auto' (flash on the card, chunked on the CPU)
    attn_impl: str = "naive"
    attn_block: int = 512
    # 'vision': raw images linear-patchified by models.frontends
    frontend: Optional[str] = None
    frontend_len: int = 0         # number of vision patches
    image_size: int = 0           # square input side, pixels
    patch_size: int = 0           # patchify window/stride, pixels
    channels: int = 3
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        """Per-head width: ``head_dim`` when set, else d_model // n_heads."""
        if self.head_dim is not None:
            return self.head_dim
        if self.n_heads <= 0:
            raise ValueError(f"{self.name}: no attention heads")
        return self.d_model // self.n_heads


_REGISTRY: dict = {}

_ARCH_MODULES = ["minitron_4b", "internlm2_20b", "qwen3_32b", "llama3_2_1b",
                 # the paper's own models (dual-encoder towers)
                 "basic_s", "basic_m", "basic_l"]


def register(cfg) -> None:
    """Add ``cfg`` to the registry under ``cfg.name``."""
    _REGISTRY[cfg.name] = cfg


def get_arch(name: str):
    """Look up a config by id (dashes or underscores)."""
    _ensure_loaded()
    key = name.replace("-", "_").replace(".", "_")
    for k, v in _REGISTRY.items():
        if k.replace("-", "_").replace(".", "_") == key:
            return v
    raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")


def list_archs():
    """Registered config ids, sorted."""
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """A reduced config of the same family: 2 layers, d_model <= 256,
    <= 4 heads, a vision geometry of <= 16 patches and a sliding window of
    64 (the reference's transform, restricted to the encoder and dense
    families)."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    if heads and cfg.n_kv_heads == cfg.n_heads:
        kv = heads
    else:
        kv = min(cfg.n_kv_heads, max(1, heads // 2)) if heads else 0
    changes = dict(
        n_layers=2,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=(d // heads if heads else None),
        d_ff=min(cfg.d_ff, 512),
        vocab=min(cfg.vocab, 512),
        frontend_len=min(cfg.frontend_len, 16),
    )
    if cfg.frontend == "vision":
        side = int(changes["frontend_len"] ** 0.5)
        if side * side != changes["frontend_len"]:
            raise ValueError(f"frontend_len {changes['frontend_len']} is not "
                             f"a square patch grid")
        ps = min(cfg.patch_size or 4, 4)
        changes["patch_size"] = ps
        changes["image_size"] = side * ps
    if cfg.sliding_window is not None:
        changes["sliding_window"] = 64
    return dataclasses.replace(cfg, **changes)
