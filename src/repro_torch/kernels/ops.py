"""The histogram dispatch and the deployment entry point for the packed model.

Histogram dispatch
------------------

``build_histogram`` selects one of three implementations, all under the
JAX package's contract (fp32 accumulation, within 1e-5 of ``ref``, count
channel exact, rows with ``pos`` outside ``[0, n_nodes)`` dropped):

  method   executes                                         "auto" picks it
  -------  -----------------------------------------------  ---------------
  "ref"    ``kernels.ref.histogram_ref`` (``index_add_``)   never
  "fused"  per-feature one-hot ``torch.matmul`` (fp32)      never
  "cuda"   ``kernels.histogram.histogram``: the CUDA        always
           kernel on the card, ``histogram_ref`` on the CPU

A configuration written by the JAX package with ``hist_method="pallas"``
(its TPU kernel) is read as ``"cuda"``, the kernel that replaces it.

``sibling_subtraction_histograms`` builds *left* children only and derives
each right child as ``parent − left`` (LightGBM's trick; every sample of a
parent lands in exactly one child, unsplit nodes routing all left).  The
right rows are passed with ``pos = -1``, so the build drops them.

Packed inference
----------------

``predict_packed_model`` takes the artifact produced by
``repro_torch.core.layout.to_packed`` and runs ``kernels.predict.packed_predict``
on it: the CUDA kernel for rows on the card, the plain version on the CPU.
``predict_packed_model_early_exit`` does the same through
``kernels.predict.packed_predict_early_exit``.  Serving moves the model's
arrays to the device once, with :func:`to_device`, and passes the resulting
:class:`DevicePacked` holder, so no batch copies the model and none reads
the model back to the host.

Binning
-------

``apply_binning`` is the entry point of ``kernels.binning.binning``: the
CUDA kernel for rows on the card, ``kernels.ref.binning_ref`` on the CPU.
As in the JAX package, nothing in the training or serving paths calls it:
``gbdt.binning.apply_bins`` bins with ``torch.searchsorted`` there, as the
JAX package's bins with ``jnp.searchsorted`` outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch._device import resolve_device

if typing.TYPE_CHECKING:  # import cycle: core.layout -> gbdt -> trainer -> ops
    from repro_torch.core.layout import PackedEnsemble
from repro_torch.kernels.binning import binning
from repro_torch.kernels.histogram import histogram, histogram_fused
from repro_torch.kernels.predict import packed_predict, packed_predict_early_exit
from repro_torch.kernels.ref import histogram_ref

HIST_METHODS = ("ref", "fused", "cuda")
#: names the JAX package's configurations use for the kernel this port replaces
_HIST_ALIASES = {"pallas": "cuda"}


def default_hist_method() -> str:
    """The "auto" rule: the CUDA kernel's wrapper (its plain version on the
    CPU)."""
    return "cuda"


def resolve_hist_method(method: str | None) -> str:
    """``None``/``"auto"`` -> the default; ``"pallas"`` -> ``"cuda"``;
    an unknown name raises."""
    if method is None or method == "auto":
        return default_hist_method()
    method = _HIST_ALIASES.get(method, method)
    if method not in HIST_METHODS:
        raise ValueError(f"unknown histogram method {method!r}; known: {HIST_METHODS}")
    return method


def build_histogram(bins, gh, pos, *, n_nodes: int, n_bins: int,
                    method: str | None = None) -> torch.Tensor:
    """(n, d) bins × (n, CH) channels × (n,) node ids -> (n_nodes, d, n_bins, CH).

    fp32 accumulation whatever the input dtype (channels are cast to fp32
    first); rows with ``pos`` outside ``[0, n_nodes)`` contribute nothing.
    ``method=None`` takes the default (module docstring).
    """
    method = resolve_hist_method(method)
    gh = gh.to(torch.float32)
    if method == "ref":
        return histogram_ref(bins, gh, pos, n_nodes, n_bins)
    if method == "fused":
        return histogram_fused(bins, gh, pos, n_nodes=n_nodes, n_bins=n_bins)
    return histogram(bins, gh, pos.to(torch.int32), n_nodes=n_nodes, n_bins=n_bins)


def sibling_subtraction_histograms(
    bins, gh, child_local, parent_hist, *, n_bins: int, method: str | None = None,
    reduce_fn=None,
) -> torch.Tensor:
    """Child-level histograms from the cached parent level, building only left
    children.

    Args:
      bins: (n, d) bin ids.
      gh: (n, CH) per-sample channels.
      child_local: (n,) node-local child ids in [0, 2*n_parents).
      parent_hist: (n_parents, d, n_bins, CH) — the previous level's
        histograms (already reduced across shards, when training
        data-parallel).
      n_bins, method: forwarded to :func:`build_histogram`.
      reduce_fn: cross-shard reduction applied to the left-child histograms
        *before* subtraction (``parent_hist`` must already be reduced).

    Returns:
      (2*n_parents, d, n_bins, CH) with ``hist[2j] == left child of j`` built
      directly and ``hist[2j+1] == parent_hist[j] - hist[2j]``.
    """
    n_parents = parent_hist.shape[0]
    # a right row goes to no node (pos -1), so the build leaves it out: the
    # kernel reads only the left rows, and every cell keeps the bits it has
    # with the right rows' channels zeroed (the JAX package's way)
    is_left = (child_local % 2) == 0
    left_pos = torch.where(is_left, torch.div(child_local, 2, rounding_mode="floor"), -1)
    left = build_histogram(bins, gh, left_pos, n_nodes=n_parents, n_bins=n_bins,
                           method=method)
    if reduce_fn is not None:
        left = reduce_fn(left)
    right = parent_hist - left
    return torch.stack([left, right], dim=1).reshape(2 * n_parents, *left.shape[1:])


def apply_binning(x, edges, *, device="cuda") -> torch.Tensor:
    """(n, d) raw floats × (d, E) sorted edges -> (n, d) int32 bins on
    ``device`` (the card unless ``device="cpu"``): ``bin = #{e < x}``, NaN
    in bin ``E`` (:func:`repro_torch.kernels.binning.binning`)."""
    device = resolve_device(device)
    return binning(as_rows(x, device),
                   torch.as_tensor(edges, dtype=torch.float32, device=device).contiguous())


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


def to_device(packed: PackedEnsemble, device, tables: dict | None = None) -> DevicePacked:
    """Copy a host :class:`PackedEnsemble` to ``device`` once.

    ``tables`` maps ``"thr_table"`` / ``"leaf_values"`` to float32 tensors
    already on ``device`` with those arrays' shapes (a fleet's shared
    copies, :mod:`repro_torch.fleet.dedup`); they are used in place of new
    copies.
    """
    put = lambda a, dtype: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype))).to(device)
    used = np.asarray(packed.used_features, np.int64)
    n_features = int(packed.n_features)
    if used.size and not (used.min() >= 0 and used.max() < n_features):
        raise ValueError(f"used_features {used.min()}..{used.max()} lie outside "
                         f"the model's {n_features} features")
    words = put(np.asarray(packed.words, np.uint32).view(np.int32), np.int32)
    tables = dict(tables or {})
    for name in ("thr_table", "leaf_values"):
        t = tables.get(name)
        if t is None:
            tables[name] = put(getattr(packed, name), np.float32)
        elif (t.device != words.device or t.dtype != torch.float32
              or tuple(t.shape) != np.shape(getattr(packed, name))):
            raise ValueError(f"shared {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, not float32 "
                             f"{np.shape(getattr(packed, name))} on {words.device}")
    return DevicePacked(
        words=words,
        leaf_ref=put(packed.leaf_ref, np.int32),
        leaf_values=tables["leaf_values"],
        thr_table=tables["thr_table"],
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
    dev, device = _on(packed, device)
    return packed_predict(as_rows(x, device), *dev.arrays(), **dev.meta(),
                          max_feature=dev.max_feature)


def predict_packed_model_early_exit(
    packed: PackedEnsemble | DevicePacked, x, bound=None, slack=None, *,
    guard: float = 0.0, min_trees: int = 0, tables=None, device="cuda",
):
    """Early-exit packed inference on ``device``: ``(scores,
    trees_evaluated, exited)``, tensors there.

    ``bound`` (the (T+1, C) float64 ``remaining_mass`` table of the packed
    tree order), ``slack``, ``guard``, ``min_trees`` and ``tables`` (the
    exit tables made once on ``device``, in place of ``bound``, ``slack`` and
    ``min_trees``) as in
    :func:`repro_torch.kernels.predict.packed_predict_early_exit`; the
    model and rows as in :func:`predict_packed_model`.
    """
    dev, device = _on(packed, device)
    return packed_predict_early_exit(
        as_rows(x, device), *dev.arrays(), bound, slack, **dev.meta(),
        guard=guard, min_trees=min_trees, max_feature=dev.max_feature, tables=tables)


def _on(packed, device) -> tuple[DevicePacked, torch.device]:
    """The model's arrays on ``device`` (copied there unless already)."""
    device = resolve_device(device)
    if isinstance(packed, DevicePacked):
        if packed.device != device:
            raise ValueError(f"the model is on {packed.device}, not on {device}")
        return packed, device
    return to_device(packed, device), device
