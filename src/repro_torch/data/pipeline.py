"""Dataset splitting + binning pipeline (paper Sec. 4.1 protocol).

A copy of ``repro.data.pipeline`` (numpy only), binning with the port's
``fit_bins``.

80/20 train/test with seeded shuffles (the paper's seeds 1-12); small
datasets use k-fold CV on the training split, larger ones carve out 10%
validation.  Also provides deterministic, stateless batch indexing for the
LM substrate: batch(step) is a pure function of (seed, step), so restarts
resume exactly (fault tolerance) and shards never need coordination
(straggler-free data plane).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synth import Dataset
from repro_torch.gbdt.binning import fit_bins


@dataclasses.dataclass(frozen=True)
class Split:
    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    edges: np.ndarray  # fit on train only


def split_dataset(ds: Dataset, seed: int = 1, n_bins: int = 256, val_frac: float = 0.1) -> Split:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ds.n)
    n_test = int(0.2 * ds.n)
    test, rest = perm[:n_test], perm[n_test:]
    n_val = max(int(val_frac * len(rest)), 1)
    val, train = rest[:n_val], rest[n_val:]
    edges = fit_bins(ds.x[train], n_bins=n_bins)
    return Split(
        x_train=ds.x[train], y_train=ds.y[train],
        x_val=ds.x[val], y_val=ds.y[val],
        x_test=ds.x[test], y_test=ds.y[test],
        edges=edges,
    )


def kfold(ds: Dataset, k: int = 5, seed: int = 1):
    """5-fold CV over the 80% training portion (used for the two smallest
    datasets, per Sec. 4.1)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ds.n)
    n_test = int(0.2 * ds.n)
    rest = perm[n_test:]
    folds = np.array_split(rest, k)
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        yield train, val, perm[:n_test]


def batch_indices(seed: int, step: int, n: int, batch: int) -> np.ndarray:
    """Stateless batch: a pure function of (seed, step).  Restart-exact."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003) + np.uint64(step))
    return rng.integers(0, n, size=batch)


def shard_rows(x: np.ndarray, n_shards: int, shard: int) -> np.ndarray:
    """Contiguous row shard for host-parallel loading."""
    per = -(-x.shape[0] // n_shards)
    return x[shard * per : (shard + 1) * per]
