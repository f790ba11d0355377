"""Standard-normal rows, and binary labels of a nonlinear rule of three
features (the rule of the repository's ``chip_smoke.draw_rows``):
``x0 - x1 + 0.3 x2^2 > 0``."""

from __future__ import annotations

import torch

from bench.core import seeds


def rule3_labels(x: torch.Tensor) -> torch.Tensor:
    return (x[:, 0] - x[:, 1] + 0.3 * x[:, 2] ** 2 > 0).to(torch.float32)


def draw(seed: int, chunk: int, n: int, d: int, device, labels: bool = False):
    gen = seeds.generator(device, seeds.sub_seed(seed, seeds.ROWS, chunk))
    x = torch.randn((n, d), generator=gen, device=device, dtype=torch.float32)
    return x, (rule3_labels(x) if labels else None)
