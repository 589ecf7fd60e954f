"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B]: small llama3 dense decoder.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, tied embeddings.

``sliding_window`` is set (the reference's SWA variant) so a decode cache
of 8192 is a ring; ``FULL_ATTENTION_VARIANT`` drops it.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    tie_embeddings=True,
    sliding_window=8192,
    rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-1B",
)
register(CONFIG)

FULL_ATTENTION_VARIANT = dataclasses.replace(
    CONFIG, name="llama3.2-1b-full", sliding_window=None)
