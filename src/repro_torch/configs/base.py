"""Architecture config and registry (copy of ``repro/configs/base.py``,
covering every config of the reference: the encoder towers of the BASIC
dual encoders and HuBERT, the dense decoder LMs, the attention-free SSM
LMs, the MoE LMs, the hybrid LM and the vlm).

Every config is a frozen dataclass built in its own ``configs/<id>.py``
module and registered here when ``get_arch`` first runs. The dense LMs
(Llama-3.2-1B, Qwen3-32B, Minitron-4B, InternLM2-20B), Mamba-2-130M
(``family="ssm"``), the MoE LMs (Mixtral-8x22B, Arctic-480B;
``family="moe"`` with a ``MoEConfig``) and the hybrid Jamba-1.5-Large
(``family="hybrid"``: Mamba-2 layers with attention every ``attn_every``
layers, and a MoE FFN every ``moe.every``) serve through the decode
engines, as does InternVL2-76B (``family="vlm"``: the vision frontend's
patches before the text, on token batches when it serves); HuBERT-XLarge
(``family="encoder"``, ``frontend="audio"``: precomputed frame embeddings,
not causal) trains on the masked-frame loss and is refused by the
engines.
``InputShape`` / ``INPUT_SHAPES`` name the assigned input shapes, and
``applicable_shapes`` says which of them an arch runs.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The MoE FFN's routing, as in the reference: ``num_experts`` SwiGLU
    experts, ``top_k`` of them per token, an optional dense SwiGLU FFN
    added beside them (Arctic), the MoE FFN on every ``every``-th block
    and the load-balance loss's coefficient."""
    num_experts: int
    top_k: int = 2
    dense_residual: bool = False
    every: int = 1
    load_balance_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """The Mamba-2 (SSD) mixer's widths, as in the reference."""
    state_dim: int = 128          # N (SSD state size)
    head_dim: int = 64            # P (channels per SSD head)
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256              # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One transformer tower: widths, masks, attention backend, and the
    vision frontend's geometry (field meanings as in the reference)."""
    name: str
    family: str                   # 'encoder' (BASIC towers, HuBERT) |
                                  # 'dense' | 'ssm' | 'moe' | 'hybrid' |
                                  # 'vlm'
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attention-free
    n_kv_heads: int
    d_ff: int                     # 0 for attention-free (mamba)
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # tokens; None = full attention
    causal: bool = True           # False for the encoder-only HuBERT
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: attention on layer i where i % attn_every == attn_every - 1,
    # Mamba-2 on every other layer; 1 means attention on every layer
    attn_every: int = 1
    # attention backend (models.attention registry): 'naive', 'chunked',
    # 'flash' (the hand-written kernel; the reference's 'pallas' maps to
    # it) or 'auto' (flash on the card, chunked on the CPU)
    attn_impl: str = "naive"
    attn_block: int = 512
    # 'vision': raw images linear-patchified by models.frontends;
    # 'audio': precomputed frame embeddings (the reference's stub)
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

    @property
    def attention_free(self) -> bool:
        """True for the SSM family, whose blocks have no attention."""
        return self.family == "ssm"

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'mamba' for the SSM family; for the hybrid
        family 'attn' on the last layer of each group of ``attn_every`` and
        'mamba' elsewhere; else 'attn'."""
        if self.family == "ssm":
            return tuple("mamba" for _ in range(self.n_layers))
        if self.family == "hybrid":
            return tuple("attn" if i % self.attn_every == self.attn_every - 1
                         else "mamba" for i in range(self.n_layers))
        return tuple("attn" for _ in range(self.n_layers))

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        """Per layer: True where the block's FFN is the MoE FFN (every
        ``moe.every``-th layer, the last of each group of ``every``)."""
        if self.moe is None:
            return tuple(False for _ in range(self.n_layers))
        return tuple((i % self.moe.every) == self.moe.every - 1
                     for i in range(self.n_layers))

    def param_counts(self) -> dict:
        """Total and active parameter counts, analytic (the reference's
        formula): per layer its attention or Mamba-2 mixer, two norms and,
        outside the SSM family, the SwiGLU FFN, or on a MoE layer
        ``num_experts`` of them in the total and ``top_k`` in the active
        count, plus one for a dense residual (the router is not counted);
        then the embedding, final norm and untied head. As in the
        reference, a Mamba-2 mixer counts 2·heads per-head parameters,
        though it holds three per-head leaves (A_log, D, dt_bias)."""
        d, V = self.d_model, self.vocab
        hd = self.resolved_head_dim if self.n_heads else 0
        q, kv = self.n_heads * hd, self.n_kv_heads * hd
        mixer = {"attn": d * q + 2 * d * kv + q * d}  # wq, wk, wv, wo
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            # in_proj (z, x, B, C, dt), conv, out_proj, A and D per head
            mixer["mamba"] = d * (2 * d_in + 2 * s.state_dim + nheads) \
                + s.conv_width * (d_in + 2 * s.state_dim) \
                + d_in * d + 2 * nheads
        ffn = 0 if self.family == "ssm" else 3 * d * self.d_ff
        total = active = V * d + d
        if not self.tie_embeddings:
            total += V * d
            active += V * d
        for kind, use_moe in zip(self.layer_kinds(), self.moe_layer_mask()):
            total += mixer[kind] + 2 * d
            active += mixer[kind] + 2 * d
            if use_moe:
                m = self.moe
                total += m.num_experts * ffn + ffn * m.dense_residual
                active += m.top_k * ffn + ffn * m.dense_residual
            else:
                total += ffn
                active += ffn
        return {"total": total, "active": active}


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned input shape: sequence length, global batch and what it
    drives ('train' | 'contrastive' | 'prefill' | 'decode')."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    # the paper's own training shape: B=65536 image-text pairs, 64-token
    # captions (paper §7.1), Algorithm-1 GradAccum with M=8192 (App. E)
    "contrastive_64k": InputShape("contrastive_64k", 64, 65536, "contrastive"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig):
    """The shapes ``cfg`` runs (the reference's skip matrix): train and
    prefill for every arch; decode for causal ones; the 500k-token decode
    for the subquadratic ones (SSM, hybrid, sliding window)."""
    names = ["train_4k", "prefill_32k"]
    if cfg.causal:  # encoder-only archs have no decode step
        names.append("decode_32k")
        subquadratic = (
            cfg.family in ("ssm", "hybrid")
            or cfg.sliding_window is not None
        )
        if subquadratic:
            names.append("long_500k")
    return [INPUT_SHAPES[n] for n in names]


_REGISTRY: dict = {}

_ARCH_MODULES = ["hubert_xlarge", "internvl2_76b", "minitron_4b",
                 "mamba2_130m", "mixtral_8x22b", "internlm2_20b",
                 "jamba_1_5_large_398b", "qwen3_32b", "llama3_2_1b",
                 "arctic_480b",
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
    <= 4 heads, a vision geometry of <= 16 patches, <= 4 experts, a
    sliding window of 64, an SSD state of 16 over heads of 32 in chunks
    of 32 and, for the hybrid family, attention every 2 layers (the
    reference's transform)."""
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
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4))
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=32, chunk=32)
    if cfg.family == "hybrid":
        changes["attn_every"] = 2
    if cfg.sliding_window is not None:
        changes["sliding_window"] = 64
    return dataclasses.replace(cfg, **changes)
