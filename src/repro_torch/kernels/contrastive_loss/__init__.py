"""Fused contrastive loss: hand-written CUDA kernels (row/column LSE, and
dX / dY / dlog_tau) and their plain versions."""
from repro_torch.kernels.contrastive_loss.ops import (  # noqa: F401
    bwd_fused,
    fused_contrastive_loss,
    fused_loss_and_lse,
    fwd_fused,
)
