"""Plain PyTorch versions of the port's kernels.

``packed_predict_ref`` is the plain version of the CUDA ``packed_predict``
kernel: the CPU tests run it, the ``packed`` backend serves with it, and
the card's smoke run holds the kernel against it.  ``histogram_ref`` is the
plain version of the CUDA ``histogram`` kernel in the same way.  Both run
on whatever device their tensors lie on.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def histogram_ref(bins, gh, pos, n_nodes: int, n_bins: int):
    """Gradient/hessian/count histograms by ``index_add_``.

    Args:
      bins: (n, d) integer bin ids (any strides).
      gh: (n, CH) per-sample channels (g, h, 1, ...): float64 is summed in
        float64, anything else in float32.
      pos: (n,) integer node-local ids.
      n_nodes, n_bins: sizes.

    Returns:
      (n_nodes, d, n_bins, CH), float32 (float64 for float64 channels).
      Rows with ``pos`` outside ``[0, n_nodes)`` and cells with a bin outside ``[0, n_bins)`` are
      dropped (``segment_sum`` drops the out-of-range ids the first makes;
      the second is outside the contract and dropped here rather than
      summed into a neighbouring feature).  Dropped entries go to one spare
      row that is cut off, so the kept ones are added in row order: on the
      CPU the result equals ``jax.ops.segment_sum`` over the same ids to
      the bit.
    """
    n, d = bins.shape
    CH = gh.shape[1]
    n_cells = n_nodes * d * n_bins
    pos = pos.to(torch.int64)
    b = bins.to(torch.int64)
    ids = (pos[:, None] * (d * n_bins)
           + torch.arange(d, device=bins.device)[None, :] * n_bins + b)
    keep = (pos[:, None] >= 0) & (pos[:, None] < n_nodes) & (b >= 0) & (b < n_bins)
    ids = torch.where(keep, ids, n_cells).reshape(-1)
    dtype = torch.float64 if gh.dtype == torch.float64 else torch.float32
    data = gh.to(dtype)[:, None, :].expand(n, d, CH).reshape(-1, CH)
    out = torch.zeros((n_cells + 1, CH), dtype=dtype, device=gh.device)
    out.index_add_(0, ids, data)
    return out[:n_cells].reshape(n_nodes, d, n_bins, CH)


def packed_predict_ref(
    x,
    words,
    leaf_ref,
    leaf_values,
    thr_table,
    thr_offsets,
    used_features,
    base_score,
    *,
    max_depth: int,
    tidx_bits: int,
    n_ensembles: int,
):
    """Traverse the bit-packed ToaD ensemble, mirroring the kernel math.

    x: (n, d) raw floats.  words: (T, I) node words, either the uint32 bit
    pattern in int32 storage or the values as int64, with
    ``word = thr_idx | (feature_ref << tidx_bits)``; ``feature_ref == |F_U|``
    marks a no-split node, which routes left.  Gather indices are clamped
    into their tables, as JAX gathers clamp.  Returns (n, C) scores with
    trees added to their class column ``t % C`` in index order.
    """
    n = x.shape[0]
    T, I = words.shape
    C = n_ensembles
    n_fu = used_features.shape[0]
    acc = torch.zeros((n, C), dtype=torch.float32, device=x.device)
    acc += base_score[None, :]
    if T == 0:
        return acc
    # int64 holds the uint32 words: torch has no uint32 shift on the CPU,
    # and an int32 view would sign-extend the top bit
    words = words.to(torch.int64) & _U32
    tmask = (1 << tidx_bits) - 1
    n_thr = thr_table.shape[0]
    n_lv = leaf_values.shape[0]
    if n_fu == 0:
        # fully-unsplit ensemble: no feature is ever consulted; pad the
        # gather tables so traversal stays in bounds
        used_features = torch.zeros((1,), dtype=torch.int32, device=x.device)
        thr_table = torch.zeros((1,), dtype=torch.float32, device=x.device)
        n_thr = 1
    feat_of = used_features.to(torch.int64)
    off_of = thr_offsets.to(torch.int64)
    rows = torch.arange(n, device=x.device)
    for t in range(T):
        row = words[t]
        idx = torch.zeros((n,), dtype=torch.int64, device=x.device)
        for _ in range(max_depth):
            word = row[idx]
            ref = word >> tidx_bits
            tix = word & tmask
            split = ref < n_fu
            safe = ref.clamp(max=max(n_fu - 1, 0))
            xv = x[rows, feat_of[safe]]
            thr = thr_table[(off_of[safe] + tix).clamp(max=n_thr - 1)]
            go_left = torch.where(split, xv <= thr, True)
            idx = 2 * idx + torch.where(go_left, 1, 2)
        lref = leaf_ref[t][idx - I].to(torch.int64).clamp(0, n_lv - 1)
        acc[:, t % C] += leaf_values[lref]
    return acc
