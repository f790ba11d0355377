"""The ToaD memory layout (paper Sec. 3.2, Figs. 2-3).

Five components, bit-packed back to back:

  1. **Metadata** — ensemble count C, tree count K, max depth, #input
     features d, |F_U|, max_f |T^f|, #global leaf values, base scores.
  2. **Feature & Threshold Map** — for every used feature (sorted by input
     index): input feature index (⌈log2 d⌉ bits), threshold bit-width as a
     power-of-two exponent (3 bits), float/int flag (1 bit), threshold count
     minus one (⌈log2 max|T^f|⌉ bits — the paper's "+1 semantics").
  3. **Global Thresholds** — per used feature, its thresholds at the chosen
     width (1/2/4/8-bit ints, 16-bit or 32-bit floats).
  4. **Global Leaf Values** — shared fp32 leaf table (paper Sec. 3.2.2).
  5. **Trees** — complete pointer-less node streams: internal slots store a
     feature *reference* (⌈log2(|F_U|+1)⌉ bits, the value |F_U| is the
     "no-split" sentinel) and, if split, a threshold index (⌈log2 max|T^f|⌉
     bits); leaf slots store a leaf-table reference (⌈log2 V⌉ bits).

**Shared-threshold-codebook variant** (``encode(forest,
thr_codebook_bits=B)``, the ``threshold_codebook`` pipeline stage): instead
of per-feature threshold values at per-feature widths, the stream carries
one *global* fp32 threshold table — every distinct threshold value in the
ensemble stored exactly once — and each feature's threshold list becomes
``⌈log2 n_cb⌉``-bit references into it (LIMITS-style fully shared tables).
Sections become:

  1'. metadata as above, plus the codebook entry count (16 bits),
  2'. feature map without the width/float fields (the table is fp32),
  3'. the global threshold codebook (n_cb × 32 bits),
  3''. per-feature reference lists into the codebook,
  4./5. leaf table and trees, unchanged.

Which variant a stream uses is carried out-of-band on
:class:`EncodedModel` (``thr_codebook_bits``; 0 = classic layout) and in
the ``.toad`` manifest, so legacy streams decode exactly as before.

Encoding/decoding is host-side numpy, as in ``repro.core.layout``: a
:class:`~repro_torch.gbdt.forest.Forest` is read through
``forest_to_numpy``, and ``encode`` gives the JAX package's bytes exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bitio import BitReader, BitWriter, bits_for
from repro_torch.gbdt.forest import Forest, forest_to_numpy

# Fixed metadata field widths (bits).  The paper leaves these unspecified
# ("some metadata"); we fix them once and use them consistently for ToaD and
# for every in-jit accounting path.
META_C_BITS = 8
META_K_BITS = 16
META_DEPTH_BITS = 8
META_D_BITS = 16
META_FU_BITS = 16
META_MAXT_BITS = 16
META_NLEAF_BITS = 32
# entry count of the shared threshold codebook (codebook-layout streams only)
META_NCB_BITS = 16


def metadata_bits(n_ensembles: int) -> int:
    return (
        META_C_BITS
        + META_K_BITS
        + META_DEPTH_BITS
        + META_D_BITS
        + META_FU_BITS
        + META_MAXT_BITS
        + META_NLEAF_BITS
        + 32 * n_ensembles
    )


# --------------------------------------------------------------------------
# Threshold width selection (paper Sec. 3.2.1 items (b)-(c))
# --------------------------------------------------------------------------


def select_width(values: np.ndarray) -> tuple[int, bool]:
    """Choose (bit-width, is_float) for a feature's threshold values.

    Ints (non-negative, exactly representable) use the smallest of
    1/2/4/8/16/32 bits; otherwise float16 if it round-trips exactly, else
    float32.  Returns (width, is_float).
    """
    values = np.asarray(values, dtype=np.float64)
    is_integral = np.all(values == np.round(values)) and np.all(values >= 0)
    if is_integral:
        for w in (1, 2, 4, 8, 16, 32):
            if np.all(values < float(2**w)):
                return w, False
    f16 = values.astype(np.float16).astype(np.float64)
    if np.allclose(f16, values, rtol=0, atol=0):
        return 16, True
    return 32, True


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------


@dataclasses.dataclass
class EncodedModel:
    """The serialized ToaD artifact.

    ``thr_codebook_bits > 0`` marks the shared-threshold-codebook stream
    layout (the nominal table size is ``<= 2**thr_codebook_bits`` entries);
    0 is the classic per-feature-width layout.  The flag travels with the
    stream (and in the ``.toad`` manifest) because the two variants are not
    self-describing at the bit level.
    """

    data: np.ndarray  # uint8 stream
    n_bits: int       # exact stream length in bits
    thr_codebook_bits: int = 0

    @property
    def n_bytes(self) -> float:
        return self.n_bits / 8.0


def _host(forest: Forest | dict) -> dict:
    """The forest's arrays as host numpy (a dict passes through)."""
    return forest if isinstance(forest, dict) else forest_to_numpy(forest)


def _used_sets(forest: Forest | dict):
    """Host-side: (sorted used feature ids, {feature: sorted used edge ids})."""
    a = _host(forest)
    K = int(a["n_trees"])
    feat = a["feature"][:K]
    thr = a["thr_bin"][:K]
    split = a["is_split"][:K]
    used: dict[int, set[int]] = {}
    for f, e in zip(feat[split].tolist(), thr[split].tolist()):
        used.setdefault(int(f), set()).add(int(e))
    features = sorted(used)
    return features, {f: sorted(used[f]) for f in features}


def used_threshold_values(forest: Forest | dict) -> np.ndarray:
    """Sorted distinct threshold *values* referenced by any split (f32)."""
    a = _host(forest)
    edges = np.asarray(a["edges"], dtype=np.float32)
    features, thr_by_feat = _used_sets(a)
    if not features:
        return np.zeros((0,), np.float32)
    vals = np.concatenate([edges[f, thr_by_feat[f]] for f in features])
    return np.unique(vals.astype(np.float32))


def encode(forest: Forest, thr_codebook_bits: int = 0) -> EncodedModel:
    """Serialize a trained forest into the five-component ToaD stream.

    ``thr_codebook_bits > 0`` selects the shared-threshold-codebook layout:
    every distinct threshold value is stored once in a global fp32 table and
    features reference it with ``⌈log2 n_cb⌉``-bit indices.  The value table
    is derived from the forest itself (its distinct used thresholds), so the
    stream stays reproducible from the forest alone; run the
    ``threshold_codebook`` pipeline stage first to actually shrink the
    distinct-value count to ``<= 2**thr_codebook_bits``.
    """
    a = forest_to_numpy(forest)
    K = int(a["n_trees"])
    D = forest.max_depth
    C = forest.n_ensembles
    d = forest.n_features
    I = 2**D - 1
    edges = a["edges"]
    features, thr_by_feat = _used_sets(a)
    n_fu = len(features)
    max_t = max((len(v) for v in thr_by_feat.values()), default=1)
    n_leaf = int(a["n_leaf_values"])
    n_leaf = max(n_leaf, 1)
    leaf_values = a["leaf_values"][:n_leaf]

    feat_to_ref = {f: r for r, f in enumerate(features)}
    # Edge-id -> per-feature threshold index.
    thr_to_idx = {f: {e: i for i, e in enumerate(es)} for f, es in thr_by_feat.items()}

    fu_bits = bits_for(n_fu + 1)          # +1: no-split sentinel
    tidx_bits = bits_for(max_t)
    cnt_bits = bits_for(max_t)
    leaf_bits = bits_for(n_leaf)
    fidx_bits = bits_for(d)

    cb_table = None
    if thr_codebook_bits > 0:
        cb_table = used_threshold_values(a)
        if len(cb_table) >= 2**META_NCB_BITS:
            raise ValueError(
                f"threshold codebook has {len(cb_table)} entries; the "
                f"{META_NCB_BITS}-bit count field caps it at "
                f"{2**META_NCB_BITS - 1}"
            )
    else:
        widths = {f: select_width(edges[f, thr_by_feat[f]]) for f in features}

    w = BitWriter()
    # (1) metadata
    w.write(C, META_C_BITS)
    w.write(K, META_K_BITS)
    w.write(D, META_DEPTH_BITS)
    w.write(d, META_D_BITS)
    w.write(n_fu, META_FU_BITS)
    w.write(max_t, META_MAXT_BITS)
    w.write(n_leaf, META_NLEAF_BITS)
    for c in range(C):
        w.write_f32(float(a["base_score"][c]))

    if cb_table is not None:
        # (1') codebook entry count, (2') slim feature map, (3') the shared
        # fp32 threshold table, (3'') per-feature references into it
        n_cb = len(cb_table)
        cb_ref_bits = bits_for(n_cb)
        w.write(n_cb, META_NCB_BITS)
        for f in features:
            w.write(f, fidx_bits)
            w.write(len(thr_by_feat[f]) - 1, cnt_bits)
        for v in cb_table.tolist():
            w.write_f32(float(v))
        for f in features:
            refs = np.searchsorted(cb_table, edges[f, thr_by_feat[f]].astype(np.float32))
            for ref, e in zip(refs.tolist(), thr_by_feat[f]):
                if cb_table[ref] != np.float32(edges[f, e]):
                    raise ValueError(
                        f"threshold {edges[f, e]!r} of feature {f} is not in "
                        f"the shared codebook — encode() derives the table "
                        f"from the forest, so this indicates corruption"
                    )
                w.write(int(ref), cb_ref_bits)
    else:
        # (2) feature & threshold map
        for f in features:
            width, is_float = widths[f]
            w.write(f, fidx_bits)
            w.write(int(np.log2(width)), 3)
            w.write(1 if is_float else 0, 1)
            w.write(len(thr_by_feat[f]) - 1, cnt_bits)

        # (3) global thresholds
        for f in features:
            width, is_float = widths[f]
            for e in thr_by_feat[f]:
                v = float(edges[f, e])
                if is_float and width == 32:
                    w.write_f32(v)
                elif is_float and width == 16:
                    w.write_f16(v)
                else:
                    w.write(int(round(v)), width)

    # (4) global leaf values (fp32, shared across all trees/ensembles)
    for v in leaf_values.tolist():
        w.write_f32(float(v))

    # (5) trees
    feat_arr = a["feature"][:K]
    thr_arr = a["thr_bin"][:K]
    split_arr = a["is_split"][:K]
    lref_arr = a["leaf_ref"][:K]
    for t in range(K):
        for i in range(I):
            if split_arr[t, i]:
                f = int(feat_arr[t, i])
                w.write(feat_to_ref[f], fu_bits)
                w.write(thr_to_idx[f][int(thr_arr[t, i])], tidx_bits)
            else:
                w.write(n_fu, fu_bits)  # no-split sentinel; no threshold field
        for j in range(2**D):
            w.write(int(lref_arr[t, j]), leaf_bits)

    return EncodedModel(
        data=w.getvalue(), n_bits=w.n_bits,
        thr_codebook_bits=int(thr_codebook_bits),
    )


# --------------------------------------------------------------------------
# Section offsets (location reporting for the structural verifier)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamOffsets:
    """Bit ranges ``[start, end)`` of every stream section, plus the parsed
    header fields the ranges were derived from.

    Produced by :func:`stream_offsets` from the metadata and feature-map
    sections alone (no tree walk): threshold/leaf section sizes follow in
    closed form from the per-feature counts and widths, and the trees
    section is whatever remains up to ``n_bits``.

    ``header`` keys: ``C, K, D, d, n_fu, max_t, n_leaf`` always;
    ``n_cb`` for codebook-layout streams; ``counts`` (per used feature) and,
    for classic streams, ``widths`` / ``is_float``; plus the derived field
    widths ``fu_bits, tidx_bits, cnt_bits, leaf_bits, fidx_bits`` (and
    ``cb_ref_bits`` for codebook streams).
    """

    header: dict
    sections: dict[str, tuple[int, int]]

    def section_at(self, bit: int) -> str:
        """Name of the section containing ``bit`` ('?' when out of range)."""
        for name, (lo, hi) in self.sections.items():
            if lo <= bit < hi:
                return name
        return "?"


def stream_offsets(model: EncodedModel) -> StreamOffsets:
    """Parse the stream header and derive every section's bit range.

    Reads only metadata + feature map (cheap, O(|F_U|)); raises
    :class:`~repro_torch.core.bitio.StreamBoundsError` when the stream is
    too short to hold them.  The trees section is not walked — its range is
    ``[trees_start, n_bits)``.
    """
    r = BitReader(model.data, model.n_bits)
    header: dict = {}
    meta_start = 0
    header["C"] = C = r.read(META_C_BITS)
    header["K"] = r.read(META_K_BITS)
    header["D"] = r.read(META_DEPTH_BITS)
    header["d"] = d = r.read(META_D_BITS)
    header["n_fu"] = n_fu = r.read(META_FU_BITS)
    header["max_t"] = max_t = r.read(META_MAXT_BITS)
    header["n_leaf"] = n_leaf = r.read(META_NLEAF_BITS)
    header["base_score"] = [r.read_f32() for _ in range(C)]

    header["fu_bits"] = bits_for(n_fu + 1)
    header["tidx_bits"] = bits_for(max_t)
    cnt_bits = header["cnt_bits"] = bits_for(max_t)
    header["leaf_bits"] = bits_for(n_leaf)
    fidx_bits = header["fidx_bits"] = bits_for(d)

    sections: dict[str, tuple[int, int]] = {}
    if model.thr_codebook_bits > 0:
        header["n_cb"] = n_cb = r.read(META_NCB_BITS)
        cb_ref_bits = header["cb_ref_bits"] = bits_for(n_cb)
        sections["metadata"] = (meta_start, r.pos)
        fmap_start = r.pos
        features, counts = [], []
        for _ in range(n_fu):
            features.append(r.read(fidx_bits))
            counts.append(r.read(cnt_bits) + 1)
        header["features"] = features
        header["counts"] = counts
        sections["feature_map"] = (fmap_start, r.pos)
        cb_start = r.pos
        cb_end = cb_start + 32 * n_cb
        sections["thr_codebook"] = (cb_start, cb_end)
        thr_end = cb_end + sum(counts) * cb_ref_bits
        sections["thresholds"] = (cb_end, thr_end)
    else:
        sections["metadata"] = (meta_start, r.pos)
        fmap_start = r.pos
        features, counts, widths, is_float = [], [], [], []
        for _ in range(n_fu):
            features.append(r.read(fidx_bits))
            widths.append(2 ** r.read(3))
            is_float.append(bool(r.read(1)))
            counts.append(r.read(cnt_bits) + 1)
        header["features"] = features
        header["counts"] = counts
        header["widths"] = widths
        header["is_float"] = is_float
        sections["feature_map"] = (fmap_start, r.pos)
        thr_start = r.pos
        thr_end = thr_start + sum(w * c for w, c in zip(widths, counts))
        sections["thr_codebook"] = (thr_start, thr_start)  # empty for classic
        sections["thresholds"] = (thr_start, thr_end)

    leaf_end = thr_end + 32 * max(n_leaf, 1)
    sections["leaf_table"] = (thr_end, leaf_end)
    sections["trees"] = (leaf_end, model.n_bits)
    return StreamOffsets(header=header, sections=sections)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DecodedModel:
    """Dense arrays reconstructed from a ToaD stream (deployment form).

    Thresholds here are *values*, not bin ids — a decoded model predicts
    straight from raw floats, like the C implementation on an MCU would.
    """

    n_ensembles: int
    max_depth: int
    n_features: int
    feature: np.ndarray      # (K, I) int32 input feature index (no-split: -1)
    thr_value: np.ndarray    # (K, I) float32
    is_split: np.ndarray     # (K, I) bool
    leaf_ref: np.ndarray     # (K, L) int32
    leaf_values: np.ndarray  # (V,) float32
    base_score: np.ndarray   # (C,) float32
    # the global tables, for packed/kernel consumption:
    used_features: np.ndarray    # (|F_U|,) int32 input feature index
    thr_table: np.ndarray        # (sum counts,) float32, per-feature contiguous
    thr_offsets: np.ndarray      # (|F_U| + 1,) int32 prefix offsets
    feature_ref: np.ndarray      # (K, I) int32 reference into used_features (no-split: |F_U|)
    thr_idx: np.ndarray          # (K, I) int32 per-feature threshold index

    def predict(self, x: np.ndarray) -> np.ndarray:
        """(n, d) raw floats -> (n, C) scores."""
        n = x.shape[0]
        K, I = self.feature.shape
        C = self.n_ensembles
        out = np.tile(self.base_score[None, :], (n, 1)).astype(np.float64)
        for t in range(K):
            idx = np.zeros(n, dtype=np.int64)
            for _ in range(self.max_depth):
                f = self.feature[t, idx]
                split = self.is_split[t, idx]
                thr = self.thr_value[t, idx]
                xv = x[np.arange(n), np.maximum(f, 0)]
                go_left = np.where(split, xv <= thr, True)
                idx = 2 * idx + np.where(go_left, 1, 2)
            ref = self.leaf_ref[t, idx - I]
            out[:, t % C] += self.leaf_values[ref]
        return out.astype(np.float32)


def decode(model: EncodedModel) -> DecodedModel:
    r = BitReader(model.data, model.n_bits)
    C = r.read(META_C_BITS)
    K = r.read(META_K_BITS)
    D = r.read(META_DEPTH_BITS)
    d = r.read(META_D_BITS)
    n_fu = r.read(META_FU_BITS)
    max_t = r.read(META_MAXT_BITS)
    n_leaf = r.read(META_NLEAF_BITS)
    base = np.array([r.read_f32() for _ in range(C)], dtype=np.float32)

    fu_bits = bits_for(n_fu + 1)
    tidx_bits = bits_for(max_t)
    cnt_bits = bits_for(max_t)
    leaf_bits = bits_for(n_leaf)
    fidx_bits = bits_for(d)

    feat_input = np.zeros(n_fu, dtype=np.int32)
    feat_count = np.zeros(n_fu, dtype=np.int32)
    if model.thr_codebook_bits > 0:
        n_cb = r.read(META_NCB_BITS)
        cb_ref_bits = bits_for(n_cb)
        for i in range(n_fu):
            feat_input[i] = r.read(fidx_bits)
            feat_count[i] = r.read(cnt_bits) + 1
        cb_table = np.array([r.read_f32() for _ in range(n_cb)], np.float32)
        thr_offsets = np.zeros(n_fu + 1, dtype=np.int32)
        np.cumsum(feat_count, out=thr_offsets[1:])
        thr_table = np.zeros(int(thr_offsets[-1]), dtype=np.float32)
        for i in range(n_fu):
            for j in range(feat_count[i]):
                thr_table[thr_offsets[i] + j] = cb_table[r.read(cb_ref_bits)]
    else:
        feat_width = np.zeros(n_fu, dtype=np.int32)
        feat_isfloat = np.zeros(n_fu, dtype=bool)
        for i in range(n_fu):
            feat_input[i] = r.read(fidx_bits)
            feat_width[i] = 2 ** r.read(3)
            feat_isfloat[i] = bool(r.read(1))
            feat_count[i] = r.read(cnt_bits) + 1

        thr_offsets = np.zeros(n_fu + 1, dtype=np.int32)
        np.cumsum(feat_count, out=thr_offsets[1:])
        thr_table = np.zeros(int(thr_offsets[-1]), dtype=np.float32)
        for i in range(n_fu):
            for j in range(feat_count[i]):
                if feat_isfloat[i] and feat_width[i] == 32:
                    v = r.read_f32()
                elif feat_isfloat[i] and feat_width[i] == 16:
                    v = r.read_f16()
                else:
                    v = float(r.read(int(feat_width[i])))
                thr_table[thr_offsets[i] + j] = v

    leaf_values = np.array([r.read_f32() for _ in range(n_leaf)], dtype=np.float32)

    I = 2**D - 1
    L = 2**D
    feature = np.full((K, I), -1, dtype=np.int32)
    feature_ref = np.full((K, I), n_fu, dtype=np.int32)
    thr_idx = np.zeros((K, I), dtype=np.int32)
    thr_value = np.zeros((K, I), dtype=np.float32)
    is_split = np.zeros((K, I), dtype=bool)
    leaf_ref = np.zeros((K, L), dtype=np.int32)
    for t in range(K):
        for i in range(I):
            ref = r.read(fu_bits)
            if ref < n_fu:
                ti = r.read(tidx_bits)
                feature_ref[t, i] = ref
                thr_idx[t, i] = ti
                feature[t, i] = feat_input[ref]
                thr_value[t, i] = thr_table[thr_offsets[ref] + ti]
                is_split[t, i] = True
        for j in range(L):
            leaf_ref[t, j] = r.read(leaf_bits)

    if r.remaining != 0:
        raise ValueError(f"{r.remaining} unread bits")
    return DecodedModel(
        n_ensembles=C,
        max_depth=D,
        n_features=d,
        feature=feature,
        thr_value=thr_value,
        is_split=is_split,
        leaf_ref=leaf_ref,
        leaf_values=leaf_values,
        base_score=base,
        used_features=feat_input,
        thr_table=thr_table,
        thr_offsets=thr_offsets,
        feature_ref=feature_ref,
        thr_idx=thr_idx,
    )


# --------------------------------------------------------------------------
# Packed form for the inference kernel
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PackedEnsemble:
    """uint32 node words + global tables: what actually ships to the device.

    Node word layout (LSB first):
      bits [0, tidx_bits)                 threshold index within feature
      bits [tidx_bits, tidx_bits+fu_bits) feature reference (|F_U| = no-split)
    """

    words: np.ndarray        # (K, I) uint32
    leaf_ref: np.ndarray     # (K, L) int32
    leaf_values: np.ndarray  # (V,) float32
    thr_table: np.ndarray    # (n_thr,) float32
    thr_offsets: np.ndarray  # (|F_U|+1,) int32
    used_features: np.ndarray  # (|F_U|,) int32
    base_score: np.ndarray   # (C,) float32
    n_ensembles: int
    max_depth: int
    tidx_bits: int
    fu_bits: int
    n_features: int = 0      # d; input width the model was trained on


def to_packed(dec: DecodedModel) -> PackedEnsemble:
    n_fu = len(dec.used_features)
    max_t = int(np.max(np.diff(dec.thr_offsets))) if n_fu else 1
    tidx_bits = bits_for(max_t)
    fu_bits = bits_for(n_fu + 1)
    words = (
        dec.thr_idx.astype(np.uint32)
        | (dec.feature_ref.astype(np.uint32) << np.uint32(tidx_bits))
    )
    return PackedEnsemble(
        words=words,
        leaf_ref=dec.leaf_ref.astype(np.int32),
        leaf_values=dec.leaf_values.astype(np.float32),
        thr_table=dec.thr_table.astype(np.float32),
        thr_offsets=dec.thr_offsets.astype(np.int32),
        used_features=dec.used_features.astype(np.int32),
        base_score=dec.base_score.astype(np.float32),
        n_ensembles=dec.n_ensembles,
        max_depth=dec.max_depth,
        tidx_bits=tidx_bits,
        fu_bits=fu_bits,
        n_features=dec.n_features,
    )


def from_packed(packed: PackedEnsemble) -> DecodedModel:
    """Exact inverse of :func:`to_packed`.

    Unpacks the uint32 node words back into the dense per-node arrays, so
    ``to_packed(from_packed(p))`` reproduces ``p`` bit for bit.  This is the
    round-trip contract the ``"packed"`` predictor backend relies on: a
    packed artifact is a complete, self-contained model.
    """
    n_fu = len(packed.used_features)
    tmask = np.uint32((1 << packed.tidx_bits) - 1)
    feature_ref = (packed.words >> np.uint32(packed.tidx_bits)).astype(np.int32)
    thr_idx = (packed.words & tmask).astype(np.int32)
    is_split = feature_ref < n_fu
    if n_fu:
        safe_ref = np.minimum(feature_ref, n_fu - 1)
        feature = np.where(is_split, packed.used_features[safe_ref], -1).astype(np.int32)
        thr_value = np.where(
            is_split,
            packed.thr_table[packed.thr_offsets[safe_ref] + thr_idx],
            np.float32(0.0),
        ).astype(np.float32)
    else:  # a fully-unsplit ensemble uses no features or thresholds at all
        feature = np.full(feature_ref.shape, -1, np.int32)
        thr_value = np.zeros(feature_ref.shape, np.float32)
    thr_idx = np.where(is_split, thr_idx, 0).astype(np.int32)
    return DecodedModel(
        n_ensembles=packed.n_ensembles,
        max_depth=packed.max_depth,
        n_features=packed.n_features,
        feature=feature,
        thr_value=thr_value,
        is_split=is_split,
        leaf_ref=packed.leaf_ref.astype(np.int32),
        leaf_values=packed.leaf_values.astype(np.float32),
        base_score=packed.base_score.astype(np.float32),
        used_features=packed.used_features.astype(np.int32),
        thr_table=packed.thr_table.astype(np.float32),
        thr_offsets=packed.thr_offsets.astype(np.int32),
        feature_ref=feature_ref,
        thr_idx=thr_idx,
    )
