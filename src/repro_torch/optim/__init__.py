"""Optimizer of the port: AdaFactorW and the LR schedules."""
from repro_torch.optim.adafactorw import (  # noqa: F401
    AdaFactorW,
    AdaFactorWState,
    apply_updates,
)
from repro_torch.optim.schedules import (  # noqa: F401
    warmup_cosine,
    warmup_linear,
)
