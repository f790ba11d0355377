"""LR schedules of the port (``repro.train.schedule``): pure functions of
the step, on float32 tensors as JAX computes them."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak=3e-4, warmup=1000, total=100_000, floor=0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine down to
    ``floor * peak`` at ``total`` and flat after.  ``step``: an integer
    tensor (any shape); the result is float32 of its shape, on its device."""
    s = step.to(torch.float32)
    warm = peak * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup, warm, cos)
