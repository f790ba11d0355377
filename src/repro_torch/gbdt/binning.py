"""Quantile feature binning (LightGBM-style histogram preprocessing).

Candidate split thresholds are the bin *edges*; training operates purely on
integer bin ids.  The binned test ``bin <= e`` is exactly the raw test
``x <= edges[e]`` because ``bin(x) = #{j : edges_j < x}``.  NaN lands past
the last edge (bin ``E``), as ``jnp.searchsorted`` puts it.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

_FEATURE_BLOCK = 16


def fit_bins(x: np.ndarray, n_bins: int = 256) -> np.ndarray:
    """Quantile bin edges per feature.

    Args:
      x: (n, d) training features (host numpy).
      n_bins: number of bins; produces n_bins - 1 candidate edges.

    Returns:
      (d, n_bins - 1) float32 edges, non-decreasing per feature.  Duplicate
      quantiles (low-cardinality features) are replaced by +inf so they are
      never selected as split candidates.

    Features are independent, so blocks of them are binned on a pool of
    threads (numpy's selection releases the GIL); each column's result is
    the same as in one call.
    """
    x = np.asarray(x)
    n, d = x.shape
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    step = _FEATURE_BLOCK
    blocks = [slice(lo, min(lo + step, d)) for lo in range(0, d, step)]
    quantile = lambda s: np.quantile(np.asarray(x[:, s], dtype=np.float64), qs, axis=0)
    if len(blocks) > 1:
        with concurrent.futures.ThreadPoolExecutor(min(len(blocks), os.cpu_count() or 1)) as pool:
            parts = list(pool.map(quantile, blocks))
    else:
        parts = [quantile(s) for s in blocks]
    edges = np.concatenate(parts, axis=1).T if parts else np.zeros((d, len(qs)))
    out = np.full_like(edges, np.inf)
    for f in range(d):
        e = edges[f]
        keep = np.concatenate([[True], e[1:] > e[:-1]])
        # de-duplicated edges, left-packed; the rest stay +inf
        kept = e[keep]
        out[f, : len(kept)] = kept
    return out.astype(np.float32)


def apply_bins(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, d) raw floats -> (n, d) int32 bin ids, bin = #{edges < x}."""
    # searchsorted over a batch of sorted rows: edges (d, E) against the
    # transposed inputs (d, n), one feature per row
    values = x.to(edges.dtype).t().contiguous()
    bins = torch.searchsorted(edges.contiguous(), values, side="left")
    return bins.t().to(torch.int32)
