"""Pluggable predictor backends behind one parity contract.

A backend turns a fitted/compressed :class:`~repro_torch.api.model.ToadModel`
into a ``(n, d) float32 -> (n, C) float32`` prediction function on the
model's device.  All registered backends must agree with the dense
reference (``repro_torch.gbdt.predict_raw``) to <= 1e-5.

Built-ins:

  * ``"reference"`` — traversal of the dense :class:`Forest` (training
    layout; no compression step needed).
  * ``"packed"``    — the plain PyTorch traversal of the packed ToaD arrays
    (``kernels.ref.packed_predict_ref``), on the model's device.
  * ``"cuda"``      — the hand-written CUDA kernel over the same packed
    arrays (``kernels.predict.packed_predict``); in place of the JAX
    package's ``pallas`` backend.  Available only on a Hopper card
    (capability 9.0).

``resolve_backend(None, ...)`` auto-selects: ``cuda`` for a compressed
model on a CUDA device (raising when the card is not Hopper), ``packed``
for a compressed model on the CPU, else ``reference``.
"""

from __future__ import annotations

import abc
import typing

import torch


class PredictorBackend(abc.ABC):
    """One way of executing a trained ToaD ensemble."""

    #: registry key; set by @register_backend
    name: str = "?"
    #: whether build() needs model.compress() to have run (packed artifact)
    requires_compressed: bool = True

    @abc.abstractmethod
    def build(self, model) -> typing.Callable:
        """Return an ``(n, d) -> (n, C)`` prediction callable."""

    def is_available(self, device) -> bool:
        """Whether this backend can run on ``device``."""
        return True


_REGISTRY: dict[str, PredictorBackend] = {}


def register_backend(cls: type[PredictorBackend]) -> type[PredictorBackend]:
    """Class decorator: instantiate and register under ``cls.name``."""
    _REGISTRY[cls.name] = cls()
    return cls


def get_backend(name: str) -> PredictorBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {', '.join(list_backends())}"
        ) from None


def list_backends() -> list[str]:
    return sorted(_REGISTRY)


def available_backends(device) -> list[str]:
    return [n for n in sorted(_REGISTRY) if _REGISTRY[n].is_available(device)]


def _hopper(device) -> bool:
    dev = torch.device(device)
    return (
        dev.type == "cuda"
        and torch.cuda.is_available()
        and torch.cuda.get_device_capability(dev) == (9, 0)
    )


def resolve_backend(name: str | None, *, compressed: bool, device) -> PredictorBackend:
    """Select a backend by name, or auto-select for the model's device.

    A compressed model on a CUDA device resolves to ``cuda`` or raises: the
    card never turns quietly to the plain PyTorch loop (``packed`` runs
    there only when asked for by name).
    """
    if name is None and compressed and torch.device(device).type == "cuda":
        if not _hopper(device):
            raise RuntimeError(
                f"the cuda backend's kernel is built for sm_90a (Hopper), and "
                f"{device} is not such a card; pass backend='packed' to run "
                f"the plain PyTorch version on it"
            )
        name = "cuda"
    if name is not None:
        b = get_backend(name)
        if not b.is_available(device):
            raise RuntimeError(f"backend {name!r} is not available on {device}")
        return b
    return get_backend("packed" if compressed else "reference")


# --------------------------------------------------------------------------
# Built-in backends
# --------------------------------------------------------------------------


@register_backend
class ReferenceBackend(PredictorBackend):
    """Traversal of the dense training-side Forest."""

    name = "reference"
    requires_compressed = False

    def build(self, model):
        from repro_torch.gbdt.forest import predict_raw
        from repro_torch.kernels.ops import as_rows

        forest = model.forest
        return lambda x: predict_raw(forest, as_rows(x, forest.device))


@register_backend
class PackedBackend(PredictorBackend):
    """The plain PyTorch traversal of the packed ToaD arrays."""

    name = "packed"

    def build(self, model):
        from repro_torch.kernels.ops import as_rows
        from repro_torch.kernels.ref import packed_predict_ref

        dev = model.device_packed()
        return lambda x: packed_predict_ref(
            as_rows(x, dev.device), *dev.arrays(), **dev.meta()
        )


@register_backend
class CudaBackend(PredictorBackend):
    """The hand-written CUDA kernel over the packed artifact."""

    name = "cuda"

    def is_available(self, device) -> bool:
        return _hopper(device)

    def build(self, model):
        from repro_torch.kernels.ops import predict_packed_model

        dev = model.device_packed()
        return lambda x: predict_packed_model(dev, x, device=dev.device)
