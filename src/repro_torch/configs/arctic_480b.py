"""Snowflake Arctic (480B) [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8), MoE 128 experts top-2 with d_ff=4864 each,
plus a dense residual FFN in parallel (dense-MoE hybrid), vocab=32000.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True),
    source="hf:Snowflake/snowflake-arctic-base",
)
register(CONFIG)
