"""Scores of a forest's raw arrays, by plain traversal.

The forest is the one the benchmark drew (``forestgen``), not the packed
model the program made of it: node ``i`` of tree ``t`` sends a row left
when it does not split or when ``x[feature] <= edges[feature, thr_bin]``;
children of ``i`` are ``2i + 1`` and ``2i + 2``; tree ``t`` adds
``leaf_values[leaf_ref[t, leaf]]`` to class ``t % C``.  ``score`` sums in
float64; ``score_low`` is the control: the same traversal with the rows,
thresholds and leaf values in bfloat16, summed in float32."""

from __future__ import annotations

import numpy as np
import torch


def _tables(forest: dict, device, dtype):
    T = int(forest["n_trees"])
    feature = torch.as_tensor(forest["feature"][:T], device=device).long()
    thr_bin = torch.as_tensor(forest["thr_bin"][:T], device=device).long()
    edges = torch.as_tensor(forest["edges"], device=device)
    thr = edges[feature, thr_bin].to(dtype)
    split = torch.as_tensor(forest["is_split"][:T], device=device)
    values = torch.as_tensor(forest["leaf_values"], device=device).to(dtype)
    leaf = values[torch.as_tensor(forest["leaf_ref"][:T], device=device).long()]
    return T, feature.reshape(-1), thr.reshape(-1), split.reshape(-1), leaf.reshape(-1)


def _walk(x, forest, C, cmp_dtype, val_dtype, sum_dtype, chunk_rows):
    T, feature, thr, split, leaf = _tables(forest, x.device, val_dtype)
    thr = thr.to(cmp_dtype)
    D = int(np.log2(np.asarray(forest["leaf_ref"]).shape[1]))
    I = 2**D - 1
    base = torch.as_tensor(forest["base_score"], device=x.device).to(sum_dtype)
    n = x.shape[0]
    chunk_rows = chunk_rows or max(1, (1 << 24) // max(T, 1))  # (rows, T) indices of 128 MiB
    out = torch.empty((n, C), dtype=sum_dtype, device=x.device)
    roots = torch.arange(T, device=x.device) * I
    cls = torch.arange(T, device=x.device) % C
    for lo in range(0, n, chunk_rows):
        rows = x[lo:lo + chunk_rows].to(cmp_dtype)
        idx = torch.zeros((rows.shape[0], T), dtype=torch.long, device=x.device)
        for _ in range(D):
            node = roots + idx
            xv = torch.gather(rows, 1, feature[node])
            right = split[node] & ~(xv <= thr[node])
            idx = 2 * idx + 1 + right.long()
        vals = leaf[torch.arange(T, device=x.device) * (I + 1) + idx - I].to(sum_dtype)
        acc = base[None, :].expand(rows.shape[0], C).clone()
        acc.index_add_(1, cls, vals)
        out[lo:lo + chunk_rows] = acc
    return out


def score(x: torch.Tensor, forest: dict, n_classes: int, chunk_rows: int = 0) -> torch.Tensor:
    """(n, d) rows -> (n, C) float64 scores."""
    return _walk(x, forest, n_classes, torch.float64, torch.float64, torch.float64,
                 chunk_rows)


def score_low(x: torch.Tensor, forest: dict, n_classes: int, chunk_rows: int = 0) -> torch.Tensor:
    """The control: (n, d) rows -> (n, C) scores with rows, thresholds and
    leaf values in bfloat16, summed in float32."""
    return _walk(x, forest, n_classes, torch.bfloat16, torch.bfloat16, torch.float32,
                 chunk_rows)
