"""Weights across the two packages.

``params_from_jax`` takes the JAX package's parameter tree as host arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's tree: the
same names, shapes and layout (the transformer family's ``{"top": {...},
"groups": [{name: (n_groups, ...)}]}``, rwkv6's ``{"top", "layers"}``,
rglru's ``{"top", "segments": [[{name: (reps, ...)}]]}``, whisper's
``{"top", "enc", "dec"}``), nothing transposed or reordered, each array
checked against ``param_shapes`` and copied into a tensor.  This is how the
tests run both packages on the same weights.  Given a device mesh, each
rank keeps its shard of every entry by ``param_specs``: the block that
``jax.device_put(params, NamedSharding(mesh, spec))`` puts on the device
at the rank's coordinates (``base.shard``).  ``state_from_jax`` carries
an optimizer's state across the same way, so a step on either package can
start from the other's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.base import ModelConfig, param_shapes, param_specs, shard


def _convert(arrays, shapes, specs, where: str, dtype_of, device, mesh):
    """A tree of host arrays checked against a parallel tree of shapes
    (dicts and lists; a tuple is a shape) and turned into tensors on
    ``device`` at ``dtype_of(name)``, ``name`` the leaf's nearest key; on a
    ``mesh``, this rank's shard of each by ``specs``, cut on the host."""
    if isinstance(shapes, dict):
        if not isinstance(arrays, dict) or set(arrays) != set(shapes):
            names = sorted(arrays) if isinstance(arrays, dict) else type(arrays).__name__
            raise ValueError(f"{where}: names {names} != {sorted(shapes)}")
        return {name: _convert(arrays[name], s, specs[name], f"{where}.{name}", dtype_of,
                               device, mesh) for name, s in shapes.items()}
    if isinstance(shapes, list):
        if not isinstance(arrays, (list, tuple)) or len(arrays) != len(shapes):
            n = len(arrays) if isinstance(arrays, (list, tuple)) else type(arrays).__name__
            raise ValueError(f"{where}: {n} entries != {len(shapes)}")
        return [_convert(a, s, sp, f"{where}[{i}]", dtype_of, device, mesh)
                for i, (a, s, sp) in enumerate(zip(arrays, shapes, specs))]
    a = np.array(arrays, dtype=np.float32)
    if a.shape != tuple(shapes):
        raise ValueError(f"{where}: shape {a.shape} != {tuple(shapes)}")
    t = torch.from_numpy(a)
    if mesh is not None:
        t = shard(t, specs, mesh)
    return t.to(device=device, dtype=dtype_of(where.rsplit(".", 1)[-1]))


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda",
                    masters: bool = False, mesh=None) -> dict:
    """The JAX package's parameter tree (host arrays) as the port's, on
    ``device`` (the card unless the caller passes ``device="cpu"``): in bf16
    (the values JAX's ``wcast`` computes with), except the family's
    ``F32_ENTRIES``, which JAX uses as fp32 masters and stay float32; with
    ``masters=True`` every entry stays float32, JAX's training masters.
    On a ``mesh`` (a ``launch.mesh.RankMesh``), this rank's shard of each
    entry, cut on the host before it moves.  Raises ``ValueError`` on a
    missing, extra or misshapen entry."""
    from repro_torch.models.registry import get_module

    device = resolve_device(device)
    f32 = get_module(cfg).F32_ENTRIES

    def dtype_of(name):
        return torch.float32 if masters or name in f32 else torch.bfloat16

    return _convert(tree, param_shapes(cfg), param_specs(cfg), "params", dtype_of, device,
                    mesh)


def state_from_jax(cfg: ModelConfig, tree, device="cuda", mesh=None):
    """The JAX package's optimizer state for ``cfg`` (``cfg.optimizer``'s
    ``init`` or ``update`` tree, host arrays: AdamW's ``{"m", "v"}``,
    Adafactor's ``{"vr", "vc"}`` or ``{"v"}`` a parameter) as the port's,
    float32 on ``device``; on a ``mesh``, this rank's shard of each entry
    by the optimizer's ``state_specs``, as the port's ``init`` of the
    rank's parameter shards lays it out.  Raises ``ValueError`` as
    :func:`params_from_jax` does."""
    from repro_torch.train.loop import state_layout
    from repro_torch.train.optimizer import get_optimizer

    specs, shapes = state_layout(cfg, get_optimizer(cfg.optimizer, cfg.learning_rate))
    return _convert(tree, shapes["opt"], specs["opt"], "opt", lambda _: torch.float32,
                    resolve_device(device), mesh)
