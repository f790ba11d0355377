"""Weights across the two packages.

``params_from_jax`` takes the JAX package's parameter tree as host arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's tree: the
same names, shapes and layout (``{"top": {...}, "groups": [{name:
(n_groups, ...)}]}``), nothing transposed or reordered, each array checked
against ``param_shapes`` and copied into a tensor.  This is how the tests
run both packages on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.base import ModelConfig, param_shapes


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The JAX package's parameter tree (host arrays) as the port's, on
    ``device`` (the card unless the caller passes ``device="cpu"``) in bf16
    (the values JAX's ``wcast`` computes with).  Raises ``ValueError`` on a
    missing, extra or misshapen entry."""
    device = resolve_device(device)
    want = param_shapes(cfg)

    def convert(arrays: dict, shapes: dict, where: str) -> dict:
        if set(arrays) != set(shapes):
            raise ValueError(f"{where}: names {sorted(arrays)} != {sorted(shapes)}")
        out = {}
        for name, shape in shapes.items():
            a = np.array(arrays[name], dtype=np.float32)
            if a.shape != tuple(shape):
                raise ValueError(f"{where}.{name}: shape {a.shape} != {tuple(shape)}")
            out[name] = torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)
        return out

    if len(tree["groups"]) != len(want["groups"]):
        raise ValueError(f"{len(tree['groups'])} layer groups != {len(want['groups'])}")
    return {
        "top": convert(tree["top"], want["top"], "top"),
        "groups": [convert(a, s, f"groups[{i}]")
                   for i, (a, s) in enumerate(zip(tree["groups"], want["groups"]))],
    }
