"""Flash-attention forward: hand-written CUDA kernel and its plain version."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
    flash_fwd,
)
