"""InternLM2-20B [arXiv:2403.17297]: dense decoder with GQA.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    source="arXiv:2403.17297",
)
register(CONFIG)
