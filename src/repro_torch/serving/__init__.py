"""Serving layer of the port: the zero-shot embedding service and the LM
decode engines (lockstep and continuous batching)."""
from repro_torch.serving.continuous import (  # noqa: F401
    ContinuousEngine,
    FinishedRequest,
)
from repro_torch.serving.embed import (  # noqa: F401
    ClassEmbeddingRegistry,
    MicroBatcher,
    ZeroShotService,
)
from repro_torch.serving.engine import Engine, sample_tokens  # noqa: F401
