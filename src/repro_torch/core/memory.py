"""Memory accounting for ToaD and the baseline layouts (paper Sec. 4.2).

Two implementations of the ToaD stream length, as in ``repro.core.memory``:

  * ``toad_bits_host`` — by construction: run the actual encoder;
  * ``toad_bits`` — closed form on tensors, evaluated inside the trainer's
    round loop on the training device without reading anything back (it
    powers ``toad_forestsize`` memory-limited training).  Bit widths come
    from integer ops, not ``log2`` on floats, so the two agree exactly.

Also the per-section breakdown, the serving-form resident bytes and the
baseline layouts (host-side).

Baseline layouts, following the paper's accounting:
  * pointer fp32  — 128 bits per node (feature id, threshold, two child
    pointers, all 32-bit), nodes = internal + leaves of the *grown* tree.
  * pointer fp16  — 64 bits per node ("quantized LightGBM").
  * array fp32    — pointer-less complete array per tree at that tree's own
    depth, 64 bits per slot (feature id + threshold/value union).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import layout as L
from repro_torch.core.bitio import bits_for
from repro_torch.gbdt.forest import Forest, forest_to_numpy


def _bits_for_tensor(n: torch.Tensor) -> torch.Tensor:
    """Tensor analogue of ``bitio.bits_for`` (⌈log2 n⌉, min 1): the bit
    length of ``max(n, 2) - 1``, counted with shifts."""
    m = torch.clamp(n.to(torch.int64), min=2) - 1
    shifts = torch.arange(63, device=m.device)
    return ((m.unsqueeze(-1) >> shifts) > 0).sum(-1)


def _threshold_widths(edges: torch.Tensor, used_thr: torch.Tensor):
    """Per-feature threshold bit width, mirroring ``layout.select_width``.

    edges: (d, E) float32; used_thr: (d, E) bool.  Returns the (d,) width
    (valid only where the feature has any used threshold) and that mask.
    """
    v = edges
    mask = used_thr
    any_used = torch.any(mask, dim=1)
    is_int = torch.all(torch.where(mask, (v == torch.round(v)) & (v >= 0), True), dim=1)
    vmax = torch.amax(torch.where(mask, v, -torch.inf), dim=1)
    int_width_idx = sum((vmax >= t).long() for t in (2.0, 4.0, 16.0, 256.0, 65536.0))
    int_widths = 2 ** int_width_idx  # 1, 2, 4, 8, 16 or 32 bits
    f16_ok = torch.all(
        torch.where(mask, v == v.to(torch.float16).to(torch.float32), True), dim=1
    )
    float_widths = torch.where(f16_ok, 16, 32)
    width = torch.where(is_int & any_used, int_widths, float_widths)
    return width, any_used


def toad_bits(
    used_feat: torch.Tensor,      # (d,) bool
    used_thr: torch.Tensor,       # (d, E) bool
    n_leaf_values: torch.Tensor,  # () int
    n_trees: torch.Tensor,        # () int
    n_splits_total: torch.Tensor, # () int  (sum of split nodes over all trees)
    edges: torch.Tensor,          # (d, E) float32
    max_depth: int,
    n_ensembles: int,
) -> torch.Tensor:
    """Exact ToaD stream length in bits, a () int64 tensor on the inputs'
    device (no read-back)."""
    d = used_feat.shape[0]
    I = 2**max_depth - 1
    Lf = 2**max_depth

    counts = torch.sum(used_thr, dim=1)                    # (d,)
    n_fu = torch.sum(used_feat)
    max_t = torch.clamp(torch.amax(counts), min=1)
    n_leaf = torch.clamp(n_leaf_values.to(torch.int64), min=1)

    fu_bits = _bits_for_tensor(n_fu + 1)
    tidx_bits = _bits_for_tensor(max_t)
    cnt_bits = _bits_for_tensor(max_t)
    leaf_bits = _bits_for_tensor(n_leaf)
    fidx_bits = bits_for(d)  # static

    meta = L.metadata_bits(n_ensembles)
    map_bits = n_fu * (fidx_bits + 3 + 1 + cnt_bits)
    widths, _ = _threshold_widths(edges, used_thr)
    thr_bits = torch.sum(torch.where(used_feat, counts * widths, 0))
    leaf_table_bits = 32 * n_leaf
    tree_bits = (n_trees.to(torch.int64) * (I * fu_bits + Lf * leaf_bits)
                 + n_splits_total.to(torch.int64) * tidx_bits)
    return meta + map_bits + thr_bits + leaf_table_bits + tree_bits


def toad_bytes(*args, **kwargs) -> torch.Tensor:
    return toad_bits(*args, **kwargs) / 8.0


def toad_bits_host(forest: Forest) -> int:
    """Ground truth: length of the actually-encoded stream."""
    return L.encode(forest).n_bits


def stream_sections(forest: Forest, thr_codebook_bits: int = 0) -> dict:
    """Per-component byte breakdown of the ToaD stream (host-side).

    The five components of paper Sec. 3.2: metadata, feature & threshold
    map, global thresholds, global leaf values, trees — plus
    ``thr_codebook_bytes``, the shared threshold table of the codebook
    stream layout (0.0 for classic streams).  ``total_bytes`` equals
    ``encode(forest, thr_codebook_bits).n_bytes`` exactly.
    """
    a = forest_to_numpy(forest)
    K = int(a["n_trees"])
    D = forest.max_depth
    C = forest.n_ensembles
    d = forest.n_features
    I = 2**D - 1
    Lf = 2**D
    features, thr_by_feat = L._used_sets(a)
    n_fu = len(features)
    max_t = max((len(v) for v in thr_by_feat.values()), default=1)
    n_leaf = max(int(a["n_leaf_values"]), 1)
    edges = a["edges"]

    fu_bits = bits_for(n_fu + 1)
    tidx_bits = bits_for(max_t)
    cnt_bits = bits_for(max_t)
    leaf_bits = bits_for(n_leaf)
    fidx_bits = bits_for(d)

    meta = L.metadata_bits(C)
    total_count = sum(len(v) for v in thr_by_feat.values())
    if thr_codebook_bits > 0:
        n_cb = len(L.used_threshold_values(a))
        meta += L.META_NCB_BITS
        fmap = n_fu * (fidx_bits + cnt_bits)
        cb_table = 32 * n_cb
        thr = total_count * bits_for(n_cb)
    else:
        fmap = n_fu * (fidx_bits + 3 + 1 + cnt_bits)
        cb_table = 0
        thr = sum(
            L.select_width(edges[f, thr_by_feat[f]])[0] * len(thr_by_feat[f])
            for f in features
        )
    leaf_table = 32 * n_leaf
    n_splits = int(a["is_split"][:K].sum())
    trees = K * (I * fu_bits + Lf * leaf_bits) + n_splits * tidx_bits
    return {
        "metadata_bytes": meta / 8.0,
        "feature_map_bytes": fmap / 8.0,
        "thr_codebook_bytes": cb_table / 8.0,
        "thresholds_bytes": thr / 8.0,
        "leaf_table_bytes": leaf_table / 8.0,
        "trees_bytes": trees / 8.0,
        "total_bytes": (meta + fmap + cb_table + thr + leaf_table + trees) / 8.0,
    }


#: the arrays of a PackedEnsemble that are resident at serving time, in the
#: order they appear on the dataclass
PACKED_ARRAYS = (
    "words",
    "leaf_ref",
    "leaf_values",
    "thr_table",
    "thr_offsets",
    "used_features",
    "base_score",
)

#: the fp32 value tables that models compressed from one ladder can share
SHARED_PACKED_ARRAYS = ("thr_table", "leaf_values")


def packed_resident_bytes(packed) -> dict:
    """Per-array resident bytes of a :class:`PackedEnsemble` serving form.

    ``total_bytes`` sums every array; ``shareable_bytes`` sums the fp32
    value tables of :data:`SHARED_PACKED_ARRAYS`.
    """
    out = {
        name: float(np.asarray(getattr(packed, name)).nbytes)
        for name in PACKED_ARRAYS
    }
    out["shareable_bytes"] = float(
        sum(out[name] for name in SHARED_PACKED_ARRAYS)
    )
    out["total_bytes"] = float(sum(out[name] for name in PACKED_ARRAYS))
    return out


# --------------------------------------------------------------------------
# Baseline layouts (paper Sec. 4.2 accounting)
# --------------------------------------------------------------------------


def pointer_bits(n_splits_total, n_trees, bits_per_node: int = 128):
    """LightGBM-style: every node of the grown tree costs ``bits_per_node``.

    A binary tree with s split nodes has s+1 leaves -> 2s+1 nodes.
    """
    nodes = 2 * np.asarray(n_splits_total) + np.asarray(n_trees)
    return nodes * bits_per_node


def quantized_pointer_bits(n_splits_total, n_trees):
    return pointer_bits(n_splits_total, n_trees, bits_per_node=64)


def array_bits(is_split: np.ndarray, n_trees, bits_per_slot: int = 64):
    """Pointer-less complete-array layout at each tree's own depth."""
    is_split = np.asarray(is_split)
    T, I = is_split.shape
    level = np.floor(np.log2(np.arange(I) + 1)).astype(np.int64)  # (I,)
    depth_t = np.max(
        np.where(is_split, level[None, :] + 1, 0), axis=1, initial=0
    )  # (T,) actual depth
    slots = 2 ** (depth_t + 1) - 1
    active = np.arange(T) < int(n_trees)
    return np.sum(np.where(active, slots, 0)) * bits_per_slot


def compression_summary(forest: Forest) -> dict:
    """Host-side summary of all layouts for a trained forest, in bytes."""
    a = forest_to_numpy(forest)
    K = int(a["n_trees"])
    n_splits = int(a["is_split"][:K].sum())
    toad = toad_bits_host(forest)
    ptr = int(pointer_bits(n_splits, K))
    qtz = int(quantized_pointer_bits(n_splits, K))
    arr = int(array_bits(a["is_split"], K))
    return {
        "toad_bytes": toad / 8.0,
        "pointer_f32_bytes": ptr / 8.0,
        "pointer_f16_bytes": qtz / 8.0,
        "array_f32_bytes": arr / 8.0,
        "compression_vs_f32": ptr / max(toad, 1),
        "compression_vs_f16": qtz / max(toad, 1),
        "n_trees": K,
        "n_split_nodes": n_splits,
    }


def reuse_factor(forest: Forest) -> float:
    """ReF (paper Sec. 4.3): (#split nodes + #reachable leaves) / #global values.

    Global values = distinct thresholds + distinct leaf values.  Only the
    grown (reachable) part of each tree counts, matching the paper's node
    and value tallies.
    """
    a = forest_to_numpy(forest)
    K = int(a["n_trees"])
    if K == 0:
        return 1.0
    split = a["is_split"][:K]
    n_splits = int(split.sum())
    n_leaves = n_splits + K  # s+1 reachable leaves per tree
    feat = a["feature"][:K]
    thr = a["thr_bin"][:K]
    pairs = {(int(f), int(e)) for f, e in zip(feat[split], thr[split])}
    n_thr = len(pairs)
    n_leaf_vals = max(int(a["n_leaf_values"]), 1)
    return (n_splits + n_leaves) / max(n_thr + n_leaf_vals, 1)
