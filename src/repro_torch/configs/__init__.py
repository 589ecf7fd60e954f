"""Configs of the port: its own copy of the reference's tower and
dual-encoder configs for the ``basic-*`` entries, of its dense decoder
LMs (``llama3.2-1b``, ``qwen3-32b``, ``minitron-4b``, ``internlm2-20b``)
and of the attention-free ``mamba2-130m``."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    SSMConfig,
    applicable_shapes,
    get_arch,
    list_archs,
    register,
    smoke_variant,
)
from repro_torch.configs.dual import (  # noqa: F401
    DualEncoderConfig,
    smoke_dual_variant,
)
