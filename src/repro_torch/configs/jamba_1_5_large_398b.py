"""Jamba-1.5-Large (398B total) [arXiv:2403.19887]: a Mamba-2 and
attention hybrid with MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; attention on every
8th layer (1:7 attention:Mamba), MoE with 16 experts, top-2, on every other
layer. Decode: the Mamba layers keep an O(1) state, the attention layers a
KV cache.
"""
from repro_torch.configs.base import (ArchConfig, MoEConfig, SSMConfig,
                                     register)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    attn_every=8,
    moe=MoEConfig(num_experts=16, top_k=2, every=2),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    source="arXiv:2403.19887",
)
register(CONFIG)
