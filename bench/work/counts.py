"""What the measured work needs of the card, counted from shapes and from
the rows' real paths: the yardstick of every roofline and MFU share.

``needed_work`` and ``histogram_work`` count as the functions of the same
names in the repository's ``chip_smoke.py`` count (frozen here, so that no
program change can move them); the rest counts the same quantities from
sizes the benchmark records.  Nothing here imports the program.
"""

from __future__ import annotations

import torch


def needed_work(p, x, trees=None):
    """What packed inference of the rows ``x`` needs of the card, counted
    along each row's real paths through the model ``p`` (a ``DevicePacked``
    with at least one used feature): through every tree, or, given
    ``trees`` (n,), through the first ``trees[r]`` trees of row ``r`` (the
    trees an early-exit row evaluates).

    Returns ``(n_bytes, n_ops, scores)``.  Bytes: each (row, feature) pair
    that a split on the row's paths compares, read once; each node word and
    leaf reference a path visits, read once; the small tables whole; the
    scores written once.  Operations: one fp32 compare per split node
    visited and one add per tree and row.  ``scores`` are the sums of the
    leaves reached, for checking that the counted paths are the real ones.
    """
    T, I = p.words.shape
    node_seen = torch.zeros(T * I, dtype=torch.bool, device=x.device)
    leaf_seen = torch.zeros(T * (I + 1), dtype=torch.bool, device=x.device)
    pairs, ops, scores = _walk(p, x, trees, node_seen, leaf_seen)
    n_bytes = 4 * (pairs + int(node_seen.sum()) + int(leaf_seen.sum()) + _tables(p)
                   + x.shape[0] * p.n_ensembles)
    return n_bytes, ops, scores


def needed_work_requests(p, x, requests, chunk_rows: int = 1 << 15) -> tuple[int, int]:
    """``needed_work`` summed over requests, each a ``(offset, n)`` slice of
    the rows ``x`` scored by one call: the node words, leaf references and
    tables that a request's paths visit are read once a request (each call
    reads them anew).  A request's rows are walked in chunks of
    ``chunk_rows``, so that the (rows, trees) indices fit; what is read once
    a call is counted once over its chunks."""
    T, I = p.words.shape
    total_bytes = total_ops = 0
    for off, n in requests:
        node_seen = torch.zeros(T * I, dtype=torch.bool, device=x.device)
        leaf_seen = torch.zeros(T * (I + 1), dtype=torch.bool, device=x.device)
        pairs = 0
        for lo in range(off, off + n, chunk_rows):
            b, ops, _ = _walk(p, x[lo:min(lo + chunk_rows, off + n)], None, node_seen,
                              leaf_seen)
            pairs += b
            total_ops += ops
        total_bytes += 4 * (pairs + int(node_seen.sum()) + int(leaf_seen.sum()) + _tables(p)
                            + n * p.n_ensembles)
    return total_bytes, total_ops


def _tables(p) -> int:
    return sum(a.numel() for a in (p.leaf_values, p.thr_table, p.thr_offsets,
                                   p.used_features, p.base_score))


def _walk(p, x, trees, node_seen, leaf_seen):
    """The rows' paths through ``p`` (through the first ``trees[r]`` trees
    of row ``r`` when given), marking the nodes and leaves they visit in
    ``node_seen`` and ``leaf_seen``; returns the (row, feature) pairs
    compared, the operations and the scores."""
    n = x.shape[0]
    T, I = p.words.shape
    n_fu = p.used_features.numel()
    C = p.n_ensembles
    words = p.words.long() & 0xFFFFFFFF
    tmask = (1 << p.tidx_bits) - 1
    uf = torch.cat([p.used_features.long(), p.used_features.new_zeros(1).long()])
    off, thr = p.thr_offsets.long(), p.thr_table
    roots = torch.arange(T, device=x.device) * I
    live = (torch.ones((n, T), dtype=torch.bool, device=x.device) if trees is None
            else torch.arange(T, device=x.device)[None, :] < trees.long()[:, None])
    idx = torch.zeros((n, T), dtype=torch.long, device=x.device)
    pair_seen = torch.zeros((n, n_fu + 1), dtype=torch.bool, device=x.device)
    compares = 0
    for _ in range(p.max_depth):
        node = roots + idx
        node_seen[node[live]] = True
        w = words.view(-1)[node]
        ref = (w >> p.tidx_bits).clamp(max=n_fu)  # n_fu: unsplit, reads no x
        split = ref < n_fu
        compares += int((split & live).sum())
        pair_seen.scatter_(1, torch.where(live, ref, n_fu), True)
        k = (off[ref] + (w & tmask)).clamp(0, thr.numel() - 1)
        right = split & ~(torch.gather(x, 1, uf[ref]) <= thr[k])
        idx = 2 * idx + 1 + right.long()
    leaf = torch.arange(T, device=x.device) * (I + 1) + idx - I
    leaf_seen[leaf[live]] = True
    values = torch.where(live, p.leaf_values[p.leaf_ref.view(-1)[leaf].long()], 0.0)
    scores = p.base_score[None, :].expand(n, C).clone()
    scores.index_add_(1, torch.arange(T, device=x.device) % C, values)
    return int(pair_seen[:, :n_fu].sum()), compares + int(live.sum()), scores


def histogram_work(bins, gh, pos, n_nodes: int, n_bins: int, kept_only: bool = False):
    """What one histogram call needs of the card: each input read once (bins
    at their storage width, gh, pos), the output written once; one fp32 add
    per (kept row, feature, channel).  ``kept_only``: the bins and channels
    of rows outside ``[0, n_nodes)`` are not needed (the trainer's call with
    right rows dropped); pos is read whole.  Returns ``(n_bytes, n_ops)``."""
    n, d = bins.shape
    CH = gh.shape[1]
    kept = int(((pos >= 0) & (pos < n_nodes)).sum())
    return histogram_work_sizes(n, d, bins.element_size(), CH, n_nodes, n_bins, kept,
                                kept_only)


def histogram_work_sizes(n: int, d: int, bin_bytes: int, CH: int, n_nodes: int,
                         n_bins: int, kept: int, kept_only: bool = False):
    """``histogram_work`` from sizes: ``n`` rows of ``d`` bins of
    ``bin_bytes`` each, ``CH`` channels, ``kept`` rows inside
    ``[0, n_nodes)``."""
    rows = kept if kept_only else n
    n_bytes = (rows * (d * bin_bytes + CH * 4) + n * 4
               + n_nodes * d * n_bins * CH * 4)
    return n_bytes, kept * d * CH


def tree_histogram_calls(n: int, d: int, n_bins: int, max_depth: int,
                         left_rows: list[int]) -> list[tuple[int, int]]:
    """``(n_bytes, n_ops)`` of each histogram call a ToaD tree needs, in
    order: level 0 over every row; levels 1 .. D-1 over the left children
    only (sibling subtraction), ``left_rows[L - 1]`` rows at level ``L``;
    the leaf statistics as one bin of a one-byte feature over every row.
    Bins are one byte (``n_bins <= 256``), three channels (g, h, count)."""
    calls = [histogram_work_sizes(n, d, 1, 3, 1, n_bins, n)]
    for level in range(1, max_depth):
        calls.append(histogram_work_sizes(n, d, 1, 3, 2 ** (level - 1), n_bins,
                                          left_rows[level - 1], kept_only=True))
    calls.append(histogram_work_sizes(n, 1, 1, 3, 2 ** max_depth, 1, n))
    return calls


def left_rows_by_level(leaf_cnt: torch.Tensor, max_depth: int) -> list[int]:
    """Rows in the left children of each level 1 .. D-1 of a complete tree
    whose leaves hold ``leaf_cnt`` (2^D,) rows (unsplit nodes route every
    row left, so a node holds the rows of its subtree's leaves)."""
    counts = leaf_cnt.double()
    out = []
    for level in range(max_depth - 1, 0, -1):
        counts = counts.view(-1, 2).sum(1)  # the 2^level nodes of this level
        out.append(int(round(float(counts[0::2].sum()))))
    return out[::-1]


def round_step_work(n: int, d: int, n_bins: int, max_depth: int,
                    left_rows: list[int]) -> tuple[int, int]:
    """``(n_bytes, n_ops)`` one boosting round (one tree) needs beyond
    nothing: the histogram calls of ``tree_histogram_calls``; per level the
    split search reading that level's histograms once (8 flops a candidate
    for the gain, 4 for the cumulative sums) and routing every row (its int64
    position read and written, its bin of the split feature read); the
    gradients (labels and scores read, g and h written) and the scores'
    update once a round."""
    n_bytes = n_ops = 0
    for b, o in tree_histogram_calls(n, d, n_bins, max_depth, left_rows):
        n_bytes += b
        n_ops += o
    for level in range(max_depth):
        cells = 2 ** level * d * n_bins * 3
        n_bytes += cells * 4 + n * (8 + 1 + 8)
        n_ops += cells * 4 + 2 ** level * d * (n_bins - 1) * 8
    n_bytes += n * (4 + 4 + 4 + 4) + n * (4 + 4)
    n_ops += n * 8
    return n_bytes, n_ops
