"""BASIC-L (paper Table 5): 48-layer/2048 image tower + 12-layer/2048 text
tower."""
from repro_torch.configs.base import register
from repro_torch.configs.dual import DualEncoderConfig, _tower

IMAGE = _tower("basic-l-image", L=48, d=2048, H=32, dff=8192, vocab=0,
               frontend="vision", frontend_len=196,
               image_size=224, patch_size=16)
TEXT = _tower("basic-l-text", L=12, d=2048, H=16, dff=8192, vocab=32768,
              head_dim=128)

CONFIG = DualEncoderConfig(name="basic-l", image_tower=IMAGE, text_tower=TEXT,
                           embed_dim=1024)
register(CONFIG)
