"""LR schedules (paper Table 6: linear warmup, then cosine or linear decay;
port of ``repro/optim/schedules.py``). Each returns ``lr(step)``, an fp32
0-d tensor on the CPU, so reading it as a float never waits on the card."""
from __future__ import annotations

import math

import torch


def _phases(max_lr, warmup_steps, total_steps, step):
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = max_lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    return step, warm, torch.clamp(t, 0.0, 1.0)


def warmup_cosine(max_lr, min_lr, warmup_steps, total_steps):
    """Linear warmup to ``max_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_lr`` at ``total_steps``."""
    def lr(step):
        step, warm, t = _phases(max_lr, warmup_steps, total_steps, step)
        cos = min_lr + 0.5 * (max_lr - min_lr) * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def warmup_linear(max_lr, min_lr, warmup_steps, total_steps):
    """Linear warmup to ``max_lr``, then a linear decay to ``min_lr``."""
    def lr(step):
        step, warm, t = _phases(max_lr, warmup_steps, total_steps, step)
        return torch.where(step < warmup_steps, warm,
                           max_lr + (min_lr - max_lr) * t)
    return lr
