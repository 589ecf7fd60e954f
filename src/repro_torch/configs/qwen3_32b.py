"""Qwen3-32B [hf:Qwen/Qwen3-8B family]: dense decoder with qk_norm + GQA.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B",
)
register(CONFIG)
