"""The scoring cells' forests, drawn from a seed (a frozen copy of
``synthetic_forest`` in the repository's ``chip_smoke.py``, with one
addition: given ``edges``, the forest splits on those and draws each used
feature's thresholds among its finite edges)."""

from __future__ import annotations

import numpy as np


def synthetic_forest(
    seed: int = 0,
    *,
    n_trees: int = 256,
    max_depth: int = 8,
    n_features: int = 256,
    n_bins: int = 256,
    n_ensembles: int = 1,
    n_used_features: int = 48,
    max_thr_per_feature: int = 16,
    n_leaf_values: int = 4096,
    edges: np.ndarray | None = None,
) -> dict:
    """Forest arrays (the artifact's forest fields) drawn from ``seed``.

    Reuse is shaped as a ToaD-trained forest shows it: splits use
    ``n_used_features`` features with at most ``max_thr_per_feature``
    thresholds each, and leaves reference a shared table of
    ``n_leaf_values`` values.  The root splits (when any feature is used);
    every other node splits with probability 0.85 if its parent split, so
    unsplit subtrees stay unsplit.  Trees are stored round-major: tree
    ``t`` adds to class ``t % n_ensembles``.  Without ``edges`` they are
    drawn as sorted standard normals (``n_bins - 1`` a feature).
    """
    rng = np.random.default_rng(seed)
    E = n_bins - 1
    I = 2**max_depth - 1
    L = 2**max_depth
    if edges is None:
        edges = np.sort(rng.standard_normal((n_features, E)), axis=1).astype(np.float32)
    else:
        edges = np.asarray(edges, np.float32)
    used = rng.choice(n_features, size=n_used_features, replace=False)
    n_valid = np.isfinite(edges).sum(1)
    pools = [
        np.sort(rng.choice(n_valid[f], size=min(max_thr_per_feature, n_valid[f]),
                           replace=False))
        for f in used
    ]
    is_split = np.zeros((n_trees, I), bool)
    feature = np.zeros((n_trees, I), np.int32)
    thr_bin = np.zeros((n_trees, I), np.int32)
    if n_used_features:
        is_split[:, 0] = True
        for i in range(1, I):
            is_split[:, i] = is_split[:, (i - 1) // 2] & (rng.random(n_trees) < 0.85)
        which = rng.integers(0, n_used_features, size=(n_trees, I))
        feature[:] = used[which]
        pick = rng.integers(0, max_thr_per_feature, size=(n_trees, I))
        for k, pool in enumerate(pools):
            mask = which == k
            thr_bin[mask] = pool[pick[mask] % len(pool)]
        feature[~is_split] = 0
        thr_bin[~is_split] = 0
    return {
        "feature": feature,
        "thr_bin": thr_bin,
        "is_split": is_split,
        "leaf_ref": rng.integers(0, n_leaf_values, size=(n_trees, L)).astype(np.int32),
        "leaf_values": (0.1 * rng.standard_normal(n_leaf_values)).astype(np.float32),
        "n_leaf_values": np.asarray(n_leaf_values, np.int32),
        "n_trees": np.asarray(n_trees, np.int32),
        "edges": edges,
        "base_score": (0.1 * rng.standard_normal(n_ensembles)).astype(np.float32),
    }
