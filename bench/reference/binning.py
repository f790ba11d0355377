"""Quantile edges and bins, worked out by the reference.

``fit_bins`` is a frozen copy of the program's ``gbdt.binning.fit_bins``
(LightGBM-style quantile edges, duplicates replaced by +inf);
``bin_rows`` bins rows on the device by a search of each feature's sorted
edges, ``bin = #{e : e < x}`` (the tests hold it to that definition,
edge by edge)."""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

_FEATURE_BLOCK = 16


def fit_bins(x: np.ndarray, n_bins: int = 256) -> np.ndarray:
    """(d, n_bins - 1) float32 quantile edges of the (n, d) rows ``x``,
    non-decreasing per feature, duplicate quantiles as +inf (left-packed)."""
    x = np.asarray(x)
    n, d = x.shape
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    blocks = [slice(lo, min(lo + _FEATURE_BLOCK, d)) for lo in range(0, d, _FEATURE_BLOCK)]
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
        kept = e[keep]
        out[f, : len(kept)] = kept
    return out.astype(np.float32)


def bin_rows(x: torch.Tensor, edges: torch.Tensor, chunk_rows: int = 1 << 20) -> torch.Tensor:
    """(n, d) floats -> (n, d) uint8 bins, ``#{e < x}``: for each feature,
    the first edge not below ``x`` in the sorted edges (+inf edges are
    below no row; the benchmark's rows hold no NaN)."""
    n, d = x.shape
    out = torch.empty((n, d), dtype=torch.uint8, device=x.device)
    for lo in range(0, n, chunk_rows):
        rows = x[lo:lo + chunk_rows].t().contiguous()  # (d, r): one feature a row
        out[lo:lo + chunk_rows] = torch.searchsorted(edges.contiguous(), rows).t().to(torch.uint8)
    return out
