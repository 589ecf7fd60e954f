"""InternVL2-76B [arXiv:2404.16821] — InternViT-6B vision encoder + InternLM2 LLM.

We implement the language backbone (80L d_model=8192 64H GQA kv=8 d_ff=28672
vocab=128256). The InternViT encoder + MLP projector is approximated by the
shared linear-patchify vision frontend (models.frontends): raw 256×256×3
images → 256 patch embeddings prepended to the token embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    frontend="vision",
    frontend_len=256,   # (256/16)² patches per image
    image_size=256,
    patch_size=16,
    source="arXiv:2404.16821",
)
register(CONFIG)
