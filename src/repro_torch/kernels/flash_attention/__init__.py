"""Flash attention: hand-written CUDA forward and backward kernels, their
plain versions, and the differentiable op the towers call."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
    flash_bwd,
    flash_fwd,
)
