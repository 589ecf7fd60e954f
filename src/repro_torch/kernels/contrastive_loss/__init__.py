"""Fused contrastive loss: hand-written CUDA kernels (row/column LSE, and
dX / dY / dlog_tau, fused and as the legacy 4-pass pair) and their plain
versions."""
from repro_torch.kernels.contrastive_loss.ops import (  # noqa: F401
    bwd_fused,
    chunk_grads,
    chunk_row_col_lse,
    fused_contrastive_loss,
    fused_contrastive_loss_4pass,
    fused_loss_and_lse,
    fused_loss_and_lse_4pass,
    fwd_fused,
    grads,
    row_col_lse,
)
