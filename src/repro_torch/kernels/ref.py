"""Plain PyTorch versions of the port's kernels.

``packed_predict_ref`` is the plain version of the CUDA ``packed_predict``
kernel: the CPU tests run it, the ``packed`` backend serves with it, and
the card's smoke run holds the kernel against it.  ``histogram_ref`` and
``packed_predict_early_exit_ref`` are the plain versions of the CUDA
``histogram`` and ``packed_predict_early_exit`` kernels in the same way,
and ``binning_ref`` that of the CUDA ``binning`` kernel.  All run on
whatever device their tensors lie on.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
#: trees per block before rounding up to a multiple of C (the JAX package's
#: ``TREE_BLOCK``): packed inference sums a block before adding it, and
#: early exit happens only at block boundaries
TREE_BLOCK = 8
#: edges compared at once, the Pallas binning kernel's ``EDGE_CHUNK``
EDGE_CHUNK = 32
#: (row, feature, edge) compares ``binning_ref`` holds at once
_BINNING_BLOCK = 1 << 26
#: rows ``histogram_ref`` spreads dropped entries over (cut off after)
_SPARE_ROWS = 1024


def tree_block_for(n_ensembles: int) -> int:
    """``TREE_BLOCK`` rounded up to a multiple of C, so a block holds whole
    rounds and tree ``k`` of a block adds to class column ``k % C``."""
    return -(-TREE_BLOCK // n_ensembles) * n_ensembles


def binning_ref(x, edges):
    """(n, d) float32 × (d, E) float32 edges -> (n, d) int32,
    ``bin = #{e < x}`` per feature.

    The Pallas kernel's arithmetic: over blocks of rows and chunks of
    ``EDGE_CHUNK`` edges, count ``x[..., None] > edges`` (an +inf edge
    never counts).  NaN, which no compare counts, is then set to ``E``,
    the bin ``apply_bins`` gives it (and ``fit``/``predict_raw`` use).
    Counts are exact, so the block sizes do not change the result.  No
    ``searchsorted``: the count holds on any edge rows, sorted or not.
    """
    n, d = x.shape
    E = edges.shape[1]
    out = torch.zeros((n, d), dtype=torch.int32, device=x.device)
    rows = max(1, _BINNING_BLOCK // max(d * min(E, EDGE_CHUNK), 1))
    for lo in range(0, n, rows):
        xb = x[lo:lo + rows, :, None]
        acc = out[lo:lo + rows]
        for c in range(0, E, EDGE_CHUNK):
            acc += (xb > edges[None, :, c:c + EDGE_CHUNK]).sum(-1, dtype=torch.int32)
    return torch.where(torch.isnan(x), E, out)


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
      summed into a neighbouring feature).  Dropped entries go to spare
      rows that are cut off (row r's to spare ``r mod _SPARE_ROWS``, so that
      a call whose right rows are dropped does not pile half its adds onto
      one address on the card), so the kept ones are added in row order: on
      the CPU the result equals ``jax.ops.segment_sum`` over the same ids
      to the bit.
    """
    n, d = bins.shape
    CH = gh.shape[1]
    n_cells = n_nodes * d * n_bins
    pos = pos.to(torch.int64)
    b = bins.to(torch.int64)
    ids = (pos[:, None] * (d * n_bins)
           + torch.arange(d, device=bins.device)[None, :] * n_bins + b)
    keep = (pos[:, None] >= 0) & (pos[:, None] < n_nodes) & (b >= 0) & (b < n_bins)
    spare = n_cells + torch.arange(n, device=bins.device)[:, None] % _SPARE_ROWS
    ids = torch.where(keep, ids, spare).reshape(-1)
    dtype = torch.float64 if gh.dtype == torch.float64 else torch.float32
    data = gh.to(dtype)[:, None, :].expand(n, d, CH).reshape(-1, CH)
    out = torch.zeros((n_cells + _SPARE_ROWS, CH), dtype=dtype, device=gh.device)
    out.index_add_(0, ids, data)
    return out[:n_cells].reshape(n_nodes, d, n_bins, CH)


def _tree_leaves(x, words, leaf_ref, leaf_values, thr_table, thr_offsets,
                 used_features, *, max_depth: int, tidx_bits: int):
    """``leaf(t)``: the (n,) leaf values tree ``t`` gives the rows of ``x``.

    words: (T, I) node words, either the uint32 bit pattern in int32
    storage or the values as int64, with ``word = thr_idx | (feature_ref <<
    tidx_bits)``; ``feature_ref == |F_U|`` marks a no-split node, which
    routes left.  Gather indices are clamped into their tables, as JAX
    gathers clamp.
    """
    n = x.shape[0]
    I = words.shape[1]
    n_fu = used_features.shape[0]
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

    def leaf(t: int) -> torch.Tensor:
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
        return leaf_values[lref]

    return leaf


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

    x: (n, d) raw floats; the packed arrays as :func:`_tree_leaves` takes
    them.  Returns (n, C) scores in the Pallas kernel's block order: trees
    in blocks of ``tree_block_for(C)``, each block summed into a zeroed
    (n, C) accumulator, tree ``k`` of the block into column ``k % C`` in
    order, and the accumulator added to the scores, which start from the
    base scores.  :func:`packed_predict_early_exit_ref` with exits disabled
    gives the same bits.
    """
    n = x.shape[0]
    T = words.shape[0]
    C = n_ensembles
    scores = torch.zeros((n, C), dtype=torch.float32, device=x.device)
    scores += base_score[None, :]
    if T == 0:
        return scores
    leaf = _tree_leaves(x, words, leaf_ref, leaf_values, thr_table, thr_offsets,
                        used_features, max_depth=max_depth, tidx_bits=tidx_bits)
    tree_block = tree_block_for(C)
    for start in range(0, T, tree_block):
        acc = torch.zeros((n, C), dtype=torch.float32, device=x.device)
        for k in range(min(tree_block, T - start)):
            acc[:, k % C] += leaf(start + k)
        scores += acc
    return scores


def packed_predict_early_exit_ref(
    x,
    words,
    leaf_ref,
    leaf_values,
    thr_table,
    thr_offsets,
    used_features,
    base_score,
    rem_blocks,
    slack,
    *,
    max_depth: int,
    tidx_bits: int,
    n_ensembles: int,
    tree_block: int,
    guard: float,
):
    """Early-exit traversal of the packed ensemble, mirroring the kernel math.

    Trees are taken in blocks of ``tree_block`` (a multiple of C).  Each
    block is summed into a zeroed (n, C) accumulator, tree ``k`` of the
    block into column ``k % C`` in order, and the accumulator is then added
    to the scores: the Pallas kernel's order.  After block ``b`` a row
    still live whose ``decision_final_mask(scores, rem_blocks[b], slack,
    guard)`` holds (float32 throughout) records ``min((b + 1) * tree_block,
    T)`` and keeps its scores from then on.

    rem_blocks: (n_tblocks, C) float32 bound rows, one per block boundary.
    slack: (C,) float32.  Returns ``(scores, exit)``: (n, C) float32 and
    (n,) int32, ``T + 1`` for a row that never became decision-final.
    """
    # lazy: the gbdt package imports the trainer, which imports this module
    from repro_torch.gbdt.early_exit import decision_final_mask

    n = x.shape[0]
    T = words.shape[0]
    C = n_ensembles
    scores = torch.zeros((n, C), dtype=torch.float32, device=x.device)
    scores += base_score[None, :]
    exit_at = torch.full((n,), T + 1, dtype=torch.int32, device=x.device)
    live = torch.ones((n,), dtype=torch.bool, device=x.device)
    if T == 0:
        return scores, exit_at
    leaf = _tree_leaves(x, words, leaf_ref, leaf_values, thr_table, thr_offsets,
                        used_features, max_depth=max_depth, tidx_bits=tidx_bits)
    for b in range(rem_blocks.shape[0]):
        start = b * tree_block
        acc = torch.zeros((n, C), dtype=torch.float32, device=x.device)
        for k in range(min(tree_block, T - start)):
            acc[:, k % C] += leaf(start + k)
        scores = torch.where(live[:, None], scores + acc, scores)
        fin = decision_final_mask(scores, rem_blocks[b], slack, guard)
        exit_at = torch.where(fin & live, min(start + tree_block, T), exit_at)
        live &= ~fin
        if not bool(live.any()):
            break
    return scores, exit_at
