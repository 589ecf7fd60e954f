"""HuBERT-XLarge [arXiv:2106.07447] — audio encoder-only transformer.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means cluster targets).
The conv waveform feature extractor is a STUB: ``input_specs`` provides
precomputed frame embeddings (batch, seq, d_model). Training objective is
masked-frame cluster prediction (BERT-style) over the 504-unit codebook.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    frontend="audio",
    rope_theta=1e4,
    source="arXiv:2106.07447",
)
register(CONFIG)
