"""Zero-shot embedding serving: micro-batcher, class-embedding registry and
the ZeroShotService front door."""
from repro_torch.serving.embed.batcher import MicroBatcher  # noqa: F401
from repro_torch.serving.embed.registry import (  # noqa: F401
    ClassEmbeddingRegistry,
    ClassMatrix,
    params_fingerprint,
)
from repro_torch.serving.embed.service import (  # noqa: F401
    ClassifyResult,
    ZeroShotService,
)
