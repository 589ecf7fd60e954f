"""Primitive layers: dense, RMSNorm, SwiGLU, RoPE (port of
``repro/models/layers.py``).

Plain functions over tensors and explicit parameter tensors. Weights are
cast to the activation dtype at use; norms and RoPE compute in fp32 and
cast back, as in the reference. The initialisers draw with the reference's
law from a ``torch.Generator`` (its bits differ from ``jax.random``'s, so
parity tests load the reference's weights through ``repro_torch.interop``).
"""
from __future__ import annotations

import torch


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with the weight cast to x's dtype: (..., i) x (i, o) -> (..., o)."""
    return torch.matmul(x, w.to(x.dtype))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMSNorm computed in fp32 whatever the input dtype; returns the input
    dtype."""
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


def swiglu(x, wi, wg, wo):
    """SwiGLU FFN: ((x@wi) * silu(x@wg)) @ wo."""
    h = dense(x, wi) * torch.nn.functional.silu(dense(x, wg))
    return dense(h, wo)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Rotary base frequencies for half the head dim, fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer. The
    rotation runs in fp32 and the result is cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].float() * freqs        # (..., seq, hd/2)
    sin = torch.sin(angles)[..., None, :]                # (..., seq, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def trunc_normal(generator: torch.Generator, shape, stddev: float,
                 device=None) -> torch.Tensor:
    """Truncated-normal init at ±2σ, fp32: a standard normal truncated to
    [-2, 2], times ``stddev`` (the reference's law). Drawn on the
    generator's device (the CPU for ``torch.Generator()``), then moved; on
    the ``meta`` device only the shape is made, nothing is drawn."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(stddev).to(device)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, extra=(),
               device=None) -> torch.Tensor:
    """Dense weight init: truncated normal with σ = d_in**-0.5, optional
    leading stack dims."""
    return trunc_normal(generator, (*extra, d_in, d_out), d_in ** -0.5,
                        device=device)
