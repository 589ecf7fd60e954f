"""Configs of the port: its own copy of the reference's tower and
dual-encoder configs for the ``basic-*`` entries, of its dense decoder
LMs (``llama3.2-1b``, ``qwen3-32b``, ``minitron-4b``, ``internlm2-20b``),
of the attention-free ``mamba2-130m``, of the MoE LMs
(``mixtral-8x22b``, ``arctic-480b``), of the hybrid
``jamba-1.5-large-398b``, of the vlm ``internvl2-76b`` and of the audio
encoder ``hubert-xlarge``: every config the reference registers."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    MoEConfig,
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
