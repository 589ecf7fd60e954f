"""Single-token GQA decode attention over a KV cache: the hand-written
split-K CUDA kernel and its plain version."""
from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    decode_attention,
)
