"""Fused similarity→top-k: hand-written CUDA kernels and their plain
version."""
from repro_torch.kernels.similarity_topk.ops import (  # noqa: F401
    classify,
    merge_topk,
    similarity_topk,
)
from repro_torch.kernels.similarity_topk.ref import (  # noqa: F401
    classify_ref,
    similarity_topk_ref,
)
