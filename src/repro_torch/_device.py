"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` whose default is ``"cuda"``.
Without a card the call raises instead of carrying on quietly on the CPU;
the CPU runs only when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, refusing CUDA when it is absent."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the card by "
            "default; pass device='cpu' (or --device cpu) to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
