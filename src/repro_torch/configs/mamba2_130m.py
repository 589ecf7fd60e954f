"""Mamba2-130M [arXiv:2405.21060]: SSD (state-space duality), attention-free.

24L d_model=768, ssm_state=128, vocab=50280, tied embeddings. No attention,
no FFN (the Mamba-2 block is the whole mixer). Decode uses the O(1)
recurrent state.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    source="arXiv:2405.21060",
)
register(CONFIG)
