"""Mixed-precision policy for the tower runtime (port of
``repro/models/precision.py``).

One ``Precision`` object travels through the towers:

  param_dtype      — dtype parameters are stored in (fp32)
  compute_dtype    — dtype of block matmuls and activations
  accum_dtype      — dtype of softmax / pooling accumulation (fp32)
  fp32_projections — run the dual-encoder embedding projections in fp32
                     even when compute is bf16

Norms always compute in fp32 (``layers.rms_norm`` casts internally).
``resolve`` accepts a registry name ('f32' | 'bf16' | 'bf16_pure'), a
``Precision``, or a bare torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """One mixed-precision policy threaded through the tower runtime."""
    name: str
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32
    fp32_projections: bool = True

    def compute(self, x):
        """Cast an activation into the block compute dtype."""
        return x.to(self.compute_dtype)

    def accum(self, x):
        """Cast into the accumulation dtype (softmax / pooling)."""
        return x.to(self.accum_dtype)

    def project(self, x):
        """Cast into the projection dtype: fp32 when the policy keeps
        projections in fp32, else the compute dtype."""
        return x.to(torch.float32 if self.fp32_projections
                    else self.compute_dtype)


POLICIES = {
    "f32": Precision("f32"),
    "bf16": Precision("bf16", compute_dtype=torch.bfloat16),
    "bf16_pure": Precision("bf16_pure", compute_dtype=torch.bfloat16,
                           fp32_projections=False),
}


def list_policies() -> list:
    """Registered precision policy names (sorted)."""
    return sorted(POLICIES)


def resolve(precision: Union[Precision, str, torch.dtype, None],
            dtype: Optional[torch.dtype] = None) -> Precision:
    """A Precision passes through; a name looks up POLICIES; a bare dtype
    (or ``dtype``) maps to the policy with that compute dtype and fp32
    islands; None means 'f32'."""
    if isinstance(precision, Precision):
        return precision
    if isinstance(precision, str):
        try:
            return POLICIES[precision]
        except KeyError:
            raise KeyError(f"unknown precision policy {precision!r}; "
                           f"have {list_policies()}") from None
    if precision is not None:
        dtype = precision
    if dtype is None:
        return POLICIES["f32"]
    for p in POLICIES.values():
        if p.compute_dtype == dtype and p.fp32_projections:
            return p
    return Precision(f"compute_{str(dtype).removeprefix('torch.')}",
                     compute_dtype=dtype)
