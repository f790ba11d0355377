"""The device mesh (``repro.launch.mesh``): a plain description for the
dry run's shard arithmetic, and a running mesh of ``torch.distributed``
ranks for the LM serving path; the per-device shard of a sharded tensor.

The JAX package builds a device mesh of (16, 16) on ``("data", "model")``,
or (2, 16, 16) on ``("pod", "data", "model")`` for two pods, over
placeholder host devices.  A :class:`Mesh` holds what the launch tooling
reads of one, the ordered ``axis_names`` and a ``shape`` mapping each axis
to its size, as JAX's ``Mesh`` exposes them, and needs no process group.
A :class:`RankMesh` is its running counterpart: a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names over
an initialised world (``gbdt.distributed.run_ranks`` starts one, the dry
run a fake one), which adds each axis's process group and this rank's
coordinates.  Ranks are laid out row-major over the axes, as JAX's
``make_mesh`` lays out devices: rank ``r`` of a (data, model) mesh sits at
``(r // model, r % model)``.

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


class RankMesh:
    """A ``DeviceMesh`` of the initialised world's first ``prod(sizes)``
    ranks, row-major, with JAX's axis names: ``axis_names`` and ``shape`` as
    :class:`Mesh` has them (so :func:`shard_shape` takes either),
    ``coords`` (this rank's index on each axis), ``group(axis)`` (that
    axis's process group: the ranks that differ from this one on that axis
    alone) and ``axis_size``/``axis_index``.

    Every rank of the world builds it (its groups are made collectively); a
    rank past the mesh's size holds no coordinates (``member`` is False)
    and takes no part.  ``device_type`` is the ranks' device: the card
    (``"cuda"``) unless the caller passes ``"cpu"``, as every entry point of
    the port (``_device.resolve_device``, which raises without a card); the
    dry run's fake world passes ``"cpu"`` and traces meta tensors."""

    def __init__(self, sizes, axis_names=("data", "model"), device_type: str = "cuda"):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch._device import resolve_device

        device_type = resolve_device(device_type).type
        sizes, axis_names = tuple(int(n) for n in sizes), tuple(axis_names)
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for the axes {axis_names}")
        n = math.prod(sizes)
        if not dist.is_initialized() or dist.get_world_size() < n:
            have = dist.get_world_size() if dist.is_initialized() else "no"
            raise ValueError(f"a {sizes} mesh needs an initialised world of at least "
                             f"{n} ranks; there is {have}")
        self.axis_names, self.sizes = axis_names, sizes
        self.device_mesh = DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                                      mesh_dim_names=axis_names)
        coords = self.device_mesh.get_coordinate()
        self.member = coords is not None
        self.coords = dict(zip(axis_names, coords)) if self.member else None

    shape = Mesh.shape

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(data: int = 2, model: int = 2) -> Mesh:
    """A small mesh: the tests' 2×2, and 1×1 for one card."""
    return Mesh(("data", "model"), (data, model))


def entry_index(entry, mesh) -> int:
    """This rank's block of a dimension split by one sharding entry: the
    row-major index over the entry's axes (JAX's order: ``("pod", "data")``
    has ``pod`` major).  ``mesh`` is a :class:`RankMesh`."""
    idx = 0
    for a in () if entry is None else (entry if isinstance(entry, tuple) else (entry,)):
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
    return idx


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
