"""Mixtral-8x22B [arXiv:2401.04088]: 8-expert top-2 MoE with sliding-window
attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2),
    source="arXiv:2401.04088",
)
register(CONFIG)
