"""Serving layer of the port: the zero-shot embedding service."""
from repro_torch.serving.embed import (  # noqa: F401
    ClassEmbeddingRegistry,
    MicroBatcher,
    ZeroShotService,
)
