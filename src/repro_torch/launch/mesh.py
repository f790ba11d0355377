"""The production mesh as a plain description (``repro.launch.mesh``), and
the per-device shard of a sharded tensor.

The JAX package builds a device mesh of (16, 16) on ``("data", "model")``,
or (2, 16, 16) on ``("pod", "data", "model")`` for two pods, over
placeholder host devices.  The port has no such devices: a
``torch.distributed.device_mesh.DeviceMesh`` of 256 cards needs an
initialised process group of that size, so none is built.  A
:class:`Mesh` holds what the launch tooling reads of one, the ordered
``axis_names`` and a ``shape`` mapping each axis to its size, as JAX's
``Mesh`` exposes them.

A sharding is a tuple with one entry a dimension (``models.base.full_spec``):
``None`` (replicated), an axis name, or a tuple of axis names, the
dimension split over their product.  An uneven split pads, as XLA does:
every device holds ``ceil(size / parts)`` of the dimension.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        """{axis name: size}, in the axes' order."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(data: int = 2, model: int = 2) -> Mesh:
    """A small mesh: the tests' 2×2, and 1×1 for one card."""
    return Mesh(("data", "model"), (data, model))


def _parts(entry, mesh: Mesh) -> int:
    """How many ways one sharding entry splits its dimension."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names)


def shard_shape(shape, spec, mesh: Mesh) -> tuple:
    """One device's shard of a tensor of ``shape`` sharded as ``spec`` (XLA's
    ceil division for a split that does not divide)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // _parts(e, mesh)) for n, e in zip(shape, spec))


def shard_bytes(shape, dtype: torch.dtype, spec, mesh: Mesh) -> int:
    """Bytes of one device's shard (:func:`shard_shape`) at ``dtype``."""
    return math.prod(shard_shape(shape, spec, mesh)) * dtype.itemsize
