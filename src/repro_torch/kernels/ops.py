"""Deployment entry point for the packed model.

``predict_packed_model`` takes the artifact produced by
``repro_torch.core.layout.to_packed`` and runs ``kernels.predict.packed_predict``
on it: the CUDA kernel for rows on the card, the plain version on the CPU.
Serving moves the model's arrays to the device once, with
:func:`to_device`, and passes the resulting :class:`DevicePacked` holder,
so no batch copies the model and none reads the model back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.layout import PackedEnsemble
from repro_torch.kernels.predict import packed_predict


@dataclasses.dataclass(frozen=True)
class DevicePacked:
    """A :class:`PackedEnsemble`'s arrays on one device, in kernel dtypes.

    ``words`` holds the uint32 node words as int32 storage (the bit pattern;
    the kernel reinterprets it as unsigned).  ``max_feature`` is the largest
    used feature (-1 when none), checked once here so that a batch needs no
    read-back to check it against x.
    """

    words: torch.Tensor
    leaf_ref: torch.Tensor
    leaf_values: torch.Tensor
    thr_table: torch.Tensor
    thr_offsets: torch.Tensor
    used_features: torch.Tensor
    base_score: torch.Tensor
    max_depth: int
    tidx_bits: int
    n_ensembles: int
    n_features: int
    max_feature: int

    @property
    def device(self) -> torch.device:
        return self.words.device

    def arrays(self) -> tuple[torch.Tensor, ...]:
        """The seven tensors in ``packed_predict`` argument order."""
        return (self.words, self.leaf_ref, self.leaf_values, self.thr_table,
                self.thr_offsets, self.used_features, self.base_score)

    def meta(self) -> dict:
        """The static keyword arguments of ``packed_predict``."""
        return {"max_depth": self.max_depth, "tidx_bits": self.tidx_bits,
                "n_ensembles": self.n_ensembles}


def to_device(packed: PackedEnsemble, device) -> DevicePacked:
    """Copy a host :class:`PackedEnsemble` to ``device`` once."""
    put = lambda a, dtype: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype))).to(device)
    used = np.asarray(packed.used_features, np.int64)
    n_features = int(packed.n_features)
    if used.size and not (used.min() >= 0 and used.max() < n_features):
        raise ValueError(f"used_features {used.min()}..{used.max()} lie outside "
                         f"the model's {n_features} features")
    return DevicePacked(
        words=put(np.asarray(packed.words, np.uint32).view(np.int32), np.int32),
        leaf_ref=put(packed.leaf_ref, np.int32),
        leaf_values=put(packed.leaf_values, np.float32),
        thr_table=put(packed.thr_table, np.float32),
        thr_offsets=put(packed.thr_offsets, np.int32),
        used_features=put(packed.used_features, np.int32),
        base_score=put(packed.base_score, np.float32),
        max_depth=int(packed.max_depth),
        tidx_bits=int(packed.tidx_bits),
        n_ensembles=int(packed.n_ensembles),
        n_features=n_features,
        max_feature=int(used.max()) if used.size else -1,
    )


def as_rows(x, device) -> torch.Tensor:
    """Host or device rows as a contiguous float32 (n, d) tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def predict_packed_model(
    packed: PackedEnsemble | DevicePacked, x, *, device="cuda"
) -> torch.Tensor:
    """(n, d) raw floats -> (n, C) scores on ``device``, straight from the
    packed artifact.

    The rows go to ``device`` (the card unless ``device="cpu"``).  A host
    :class:`PackedEnsemble` is copied there on every call; pass a
    :class:`DevicePacked` on ``device`` to serve without the copy.
    """
    device = resolve_device(device)
    if isinstance(packed, DevicePacked):
        if packed.device != device:
            raise ValueError(f"the model is on {packed.device}, not on {device}")
        dev = packed
    else:
        dev = to_device(packed, device)
    return packed_predict(as_rows(x, device), *dev.arrays(), **dev.meta(),
                          max_feature=dev.max_feature)
