"""Device selection for the port's entry points.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise rather than fall back,
so a run that believes it measured the card really ran there.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked. Picking the card also turns TF32 off for the library's
    matmuls and cuDNN, so the ``f32`` precision policy means full fp32, as
    in the reference. The port's own f32 flash-attention kernels run their
    products on the tensor cores as split 3×TF32 (each operand split into
    two tf32 halves, three products summed in fp32: about 2^-21 of each
    product, against 2^-11 for plain TF32), which keeps fp32 accuracy and
    is held to the same f32 limits."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
