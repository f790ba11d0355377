"""Weights across the two packages.

``params_from_jax`` takes the JAX package's parameter tree as host arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's tree: the
same names, shapes and layout (the transformer family's ``{"top": {...},
"groups": [{name: (n_groups, ...)}]}``, rwkv6's ``{"top", "layers"}``,
rglru's ``{"top", "segments": [[{name: (reps, ...)}]]}``, whisper's
``{"top", "enc", "dec"}``), nothing transposed or reordered, each array
checked against ``param_shapes`` and copied into a tensor.  This is how the
tests run both packages on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.base import ModelConfig, param_shapes


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda",
                    masters: bool = False) -> dict:
    """The JAX package's parameter tree (host arrays) as the port's, on
    ``device`` (the card unless the caller passes ``device="cpu"``): in bf16
    (the values JAX's ``wcast`` computes with), except the family's
    ``F32_ENTRIES``, which JAX uses as fp32 masters and stay float32; with
    ``masters=True`` every entry stays float32, JAX's training masters.
    Raises ``ValueError`` on a missing, extra or misshapen entry."""
    from repro_torch.models.registry import get_module

    device = resolve_device(device)
    f32 = get_module(cfg).F32_ENTRIES

    def convert(arrays, shapes, where: str):
        if isinstance(shapes, dict):
            if not isinstance(arrays, dict) or set(arrays) != set(shapes):
                names = sorted(arrays) if isinstance(arrays, dict) else type(arrays).__name__
                raise ValueError(f"{where}: names {names} != {sorted(shapes)}")
            return {name: convert(arrays[name], s, f"{where}.{name}")
                    for name, s in shapes.items()}
        if isinstance(shapes, list):
            if not isinstance(arrays, (list, tuple)) or len(arrays) != len(shapes):
                n = len(arrays) if isinstance(arrays, (list, tuple)) else type(arrays).__name__
                raise ValueError(f"{where}: {n} entries != {len(shapes)}")
            return [convert(a, s, f"{where}[{i}]")
                    for i, (a, s) in enumerate(zip(arrays, shapes))]
        a = np.array(arrays, dtype=np.float32)
        if a.shape != tuple(shapes):
            raise ValueError(f"{where}: shape {a.shape} != {tuple(shapes)}")
        name = where.rsplit(".", 1)[-1]
        dtype = torch.float32 if masters or name in f32 else torch.bfloat16
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    return convert(tree, param_shapes(cfg), "params")
