"""BASIC-S (paper Table 5): an 8-layer/768 image tower over a linear
patchify frontend (224×224×3 pixels, 16-pixel patches, 196 positions) and a
6-layer/1024 text tower with head dim 64."""
from repro_torch.configs.base import register
from repro_torch.configs.dual import DualEncoderConfig, _tower

IMAGE = _tower("basic-s-image", L=8, d=768, H=12, dff=3072, vocab=0,
               frontend="vision", frontend_len=196,
               image_size=224, patch_size=16)
TEXT = _tower("basic-s-text", L=6, d=1024, H=16, dff=4096, vocab=32768,
              head_dim=64)

CONFIG = DualEncoderConfig(name="basic-s", image_tower=IMAGE, text_tower=TEXT,
                           embed_dim=512)
register(CONFIG)
