"""In-memory representation of a boosted complete-tree ensemble.

The layout mirrors the paper's pointer-less scheme (Sec. 3.2.1): every tree
is a *complete* binary tree of depth ``max_depth``; the children of the node
stored at index ``i`` live at ``2i+1`` (left) and ``2i+2`` (right).  Internal
node slots that did not split are marked ``is_split == False`` and route
traffic to their *left* subtree, so every traversal terminates in one of the
``2**max_depth`` leaf slots.

Leaf slots do not store values directly; they store *references* into the
global leaf-value table (paper Sec. 3.2.2), which is shared across all trees
and, for multiclass problems, across all per-class ensembles.

Thresholds are bin-edge indices: ``thr_bin[t, i] == e`` means the split test
is ``x[feature] <= edges[feature, e]``.

:func:`forest_from_numpy` / :func:`forest_to_numpy` carry a forest across
packages and files: the keys are the artifact's forest fields, so a
``repro`` (JAX) forest converts with
``{f: np.asarray(getattr(forest, f)) for f in FOREST_FIELDS}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.gbdt.binning import apply_bins

#: the forest arrays an artifact stores, in order (``repro.api.model``'s
#: ``_FOREST_FIELDS``)
FOREST_FIELDS = (
    "feature",
    "thr_bin",
    "is_split",
    "leaf_ref",
    "leaf_values",
    "n_leaf_values",
    "n_trees",
    "edges",
    "base_score",
)

_DTYPES = {
    "feature": torch.int32,
    "thr_bin": torch.int32,
    "is_split": torch.bool,
    "leaf_ref": torch.int32,
    "leaf_values": torch.float32,
    "n_leaf_values": torch.int32,
    "n_trees": torch.int32,
    "edges": torch.float32,
    "base_score": torch.float32,
}


@dataclasses.dataclass(frozen=True)
class Forest:
    """A boosted ensemble of complete binary trees.

    Shapes (``T`` = capacity in trees, ``I = 2**D - 1`` internal slots,
    ``L = 2**D`` leaf slots, ``V`` = leaf-table capacity, ``d`` = number of
    input features, ``E`` = bins - 1 candidate edges per feature):
    """

    feature: torch.Tensor      # (T, I) int32, input feature index per internal slot
    thr_bin: torch.Tensor      # (T, I) int32, edge index into ``edges[feature]``
    is_split: torch.Tensor     # (T, I) bool
    leaf_ref: torch.Tensor     # (T, L) int32 index into ``leaf_values``
    leaf_values: torch.Tensor  # (V,) float32 global shared leaf-value table
    n_leaf_values: torch.Tensor  # () int32, #used slots in ``leaf_values``
    n_trees: torch.Tensor      # () int32, #trees actually grown (<= T)
    edges: torch.Tensor        # (d, E) float32 candidate thresholds (bin edges)
    base_score: torch.Tensor   # (C,) float32 initial prediction per ensemble
    n_ensembles: int = 1       # C; trees are stored round-major: tree r*C + c

    @property
    def max_depth(self) -> int:
        return int(np.log2(self.leaf_ref.shape[1]))

    @property
    def tree_capacity(self) -> int:
        return self.feature.shape[0]

    @property
    def n_features(self) -> int:
        return self.edges.shape[0]

    @property
    def n_bins(self) -> int:
        return self.edges.shape[1] + 1

    @property
    def device(self) -> torch.device:
        return self.edges.device


def forest_from_numpy(arrays: dict, n_ensembles: int = 1, device="cuda") -> Forest:
    """A :class:`Forest` on ``device`` from host arrays keyed by FOREST_FIELDS."""
    dev = resolve_device(device)
    return Forest(
        **{
            f: torch.from_numpy(np.array(arrays[f])).to(dev, _DTYPES[f])
            for f in FOREST_FIELDS
        },
        n_ensembles=int(n_ensembles),
    )


def forest_to_numpy(forest: Forest) -> dict:
    """The forest's arrays on the host, keyed by FOREST_FIELDS."""
    return {f: getattr(forest, f).detach().cpu().numpy() for f in FOREST_FIELDS}


# --------------------------------------------------------------------------
# Reference prediction (the oracle for the packed layouts and the kernel)
# --------------------------------------------------------------------------


def predict_binned(forest: Forest, bins: torch.Tensor) -> torch.Tensor:
    """Ensemble prediction from pre-binned inputs.

    Args:
      forest: the ensemble.
      bins: (n, d) integer bin ids, ``bin = sum_j [x > edges_j]``.

    Returns:
      (n, C) raw scores (sum of per-class trees + base score), trees added
      to their class column in index order.
    """
    n = bins.shape[0]
    C = forest.n_ensembles
    I = forest.feature.shape[1]
    bins = bins.to(torch.int64)
    acc = torch.zeros((n, C), dtype=torch.float32, device=bins.device)
    acc += forest.base_score[None, :]
    n_trees = min(int(forest.n_trees), forest.tree_capacity)
    for t in range(n_trees):
        feature = forest.feature[t].to(torch.int64)
        thr = forest.thr_bin[t]
        split = forest.is_split[t]
        idx = torch.zeros((n,), dtype=torch.int64, device=bins.device)
        for _ in range(forest.max_depth):
            feat = feature[idx].clamp_(min=0)
            x_bin = bins.gather(1, feat[:, None])[:, 0]
            go_left = torch.where(split[idx], x_bin <= thr[idx], True)
            idx = 2 * idx + torch.where(go_left, 1, 2)
        ref = forest.leaf_ref[t][idx - I].to(torch.int64)
        acc[:, t % C] += forest.leaf_values[ref]
    return acc


def predict_raw(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """Prediction from raw (un-binned) float inputs, as a deployed model would."""
    return predict_binned(forest, apply_bins(x, forest.edges))


def empty_forest(
    n_features: int,
    n_edges: int,
    tree_capacity: int,
    max_depth: int,
    leaf_capacity: int,
    n_ensembles: int = 1,
    device="cuda",
) -> Forest:
    """An all-unsplit forest with zeroed tables."""
    dev = resolve_device(device)
    I = 2**max_depth - 1
    L = 2**max_depth
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)
    return Forest(
        feature=z((tree_capacity, I), torch.int32),
        thr_bin=z((tree_capacity, I), torch.int32),
        is_split=z((tree_capacity, I), torch.bool),
        leaf_ref=z((tree_capacity, L), torch.int32),
        leaf_values=z((leaf_capacity,), torch.float32),
        n_leaf_values=z((), torch.int32),
        n_trees=z((), torch.int32),
        edges=z((n_features, n_edges), torch.float32),
        base_score=z((n_ensembles,), torch.float32),
        n_ensembles=n_ensembles,
    )
