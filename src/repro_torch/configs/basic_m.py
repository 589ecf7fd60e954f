"""BASIC-M (paper Table 5): 24-layer/1024 image tower + 12-layer/1024 text
tower."""
from repro_torch.configs.base import register
from repro_torch.configs.dual import DualEncoderConfig, _tower

IMAGE = _tower("basic-m-image", L=24, d=1024, H=16, dff=4096, vocab=0,
               frontend="vision", frontend_len=196,
               image_size=224, patch_size=16)
TEXT = _tower("basic-m-text", L=12, d=1024, H=8, dff=4096, vocab=32768,
              head_dim=128)

CONFIG = DualEncoderConfig(name="basic-m", image_tower=IMAGE, text_tower=TEXT,
                           embed_dim=768)
register(CONFIG)
