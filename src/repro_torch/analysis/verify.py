"""toadcheck of the port: structural verification of ``.toad`` artifacts.

The port of ``repro.analysis.verify``'s artifact half.  Walks a bundle or a
raw :class:`~repro_torch.core.layout.EncodedModel` stream *without
decoding-to-predict* and emits typed diagnostics
(:class:`~repro_torch.analysis.diagnostics.Diagnostic`), with the JAX
package's codes, so a malformed stream is refused before a single bit is
dereferenced on the card:

* **stream level** (:func:`verify_stream`, ``TOAD001``-``TOAD010``) —
  payload bounds (no field may read past the declared length), metadata
  domain rules, feature-map monotonicity, threshold/codebook invariants
  (table sorted + finite, refs < table size, per-feature threshold lists
  non-decreasing so ``bin<=e <=> x<=edges[e]`` survives), and forest
  topology (feature refs/threshold indices/leaf refs in range, splits
  reachable).
* **bundle level** (:func:`verify_bundle` / :func:`verify_artifact`,
  ``TOAD101``-``TOAD108``) — format-version rules (range + the
  lowest-sufficient-version negotiation contract), manifest byte
  accounting cross-checked against ``core.memory.stream_sections`` and the
  actual payload length, spec<->stream layout agreement, the sha256 stream
  digest, and the dense forest arrays (edge-row monotonicity, reference
  ranges).
* **early-exit bounds** (``TOAD120``/``TOAD121``) — a bundle that ships an
  ``early_exit`` section (bound table + policy) is checked structurally
  (shape, monotone non-increasing suffix, zero final row, parseable
  policy), and its ``remaining_mass`` table is recomputed from the shipped
  trees (``core.treeorder``) and must match.

Every finding is located via :func:`repro_torch.core.layout.stream_offsets`
(section name + bit offset) and carries a fix hint.  The walk reads
headers with the scalar :class:`~repro_torch.core.bitio.BitReader` and bulk
sections with the vectorized ``read_array``, builds no dense arrays, and
never predicts.  It is host work on numpy arrays: no device is touched.

``repro_torch.api.artifact.load_artifact(verify=True)`` runs
:func:`verify_bundle` *before* decode and refuses on any error-severity
finding; ``save_artifact`` runs it post-encode, so a faulty encoder cannot
ship a malformed bundle.  The ``.toadpack`` container (``verify_pack``,
TOAD110-TOAD114) and the fleet check (``verify_fleet``) come with the
streaming and fleet slices: :func:`verify_artifact` refuses a ``.toadpack``
with ``NotImplementedError`` until then.
"""

from __future__ import annotations

import json
from typing import Mapping

import numpy as np

from repro_torch.analysis.diagnostics import WARNING, Diagnostic, errors
from repro_torch.core.bitio import BitReader, StreamBoundsError
from repro_torch.core.layout import EncodedModel, stream_offsets
from repro_torch.core.memory import stream_sections
from repro_torch.gbdt.forest import FOREST_FIELDS

# metadata domain caps: generous, but small enough that a corrupted header
# cannot make the verifier itself allocate or loop unboundedly
_MAX_DEPTH = 24

#: the leading bytes of a ``.toadpack`` v4 streaming container
PACK_MAGIC = b"TOADPACK"


def _max_format_version() -> int:
    from repro_torch.api.artifact import TOAD_FORMAT_VERSION  # lazy: import cycle

    return TOAD_FORMAT_VERSION


# --------------------------------------------------------------------------
# Stream-level verification
# --------------------------------------------------------------------------


def verify_stream(encoded: EncodedModel, path: str = "") -> list[Diagnostic]:
    """Structurally verify one encoded ToaD stream (no decode-to-predict).

    Returns every finding; the stream is safe to decode iff none has
    severity ``error``.
    """
    diags: list[Diagnostic] = []

    def diag(code, message, section="", bit=-1, severity=""):
        diags.append(Diagnostic(code=code, message=message, file=path,
                                section=section, bit_offset=bit,
                                severity=severity))

    data = np.asarray(encoded.data, np.uint8)
    n_bits = int(encoded.n_bits)
    expect_bytes = (n_bits + 7) // 8
    if len(data) < expect_bytes:
        diag("TOAD001",
             f"payload holds {len(data)} bytes but the declared length "
             f"{n_bits} bits needs {expect_bytes}",
             section="metadata", bit=8 * len(data))
        return diags
    if len(data) > expect_bytes:
        diag("TOAD002",
             f"payload holds {len(data)} bytes, {len(data) - expect_bytes} "
             f"more than the declared {n_bits} bits occupy",
             section="trees", bit=n_bits)

    try:
        so = stream_offsets(encoded)
    except StreamBoundsError as e:
        diag("TOAD001", f"stream ends inside the header: {e}",
             section="metadata", bit=max(e.pos, 0))
        return diags
    h = so.header

    def sec(name):
        return so.sections.get(name, (0, 0))[0]

    # ---- metadata domain (TOAD003/TOAD004) -------------------------------
    bad_meta = False
    for field, value, ok in (
        ("C (ensembles)", h["C"], h["C"] >= 1),
        ("D (max depth)", h["D"], 1 <= h["D"] <= _MAX_DEPTH),
        ("d (features)", h["d"], h["d"] >= 1),
        ("|F_U|", h["n_fu"], h["n_fu"] <= h["d"]),
        ("max|T^f|", h["max_t"], h["max_t"] >= 1),
        ("V (leaf values)", h["n_leaf"], h["n_leaf"] >= 1),
    ):
        if not ok:
            diag("TOAD003", f"metadata field {field} = {value} is out of "
                 f"domain", section="metadata", bit=0)
            bad_meta = True
    if not all(np.isfinite(h["base_score"])):
        diag("TOAD004", f"base score is not finite: {h['base_score']}",
             section="metadata", bit=0)
    if bad_meta:
        return diags  # field widths below derive from these; stop here

    counts = h["counts"]
    for i, c in enumerate(counts):
        if c > h["max_t"]:
            diag("TOAD005", f"feature-map entry {i}: threshold count {c} "
                 f"exceeds the declared max|T^f| = {h['max_t']}",
                 section="feature_map", bit=sec("feature_map"))
    feats = h["features"]
    for i, f in enumerate(feats):
        if f >= h["d"]:
            diag("TOAD005", f"feature-map entry {i}: input feature index "
                 f"{f} >= d = {h['d']}",
                 section="feature_map", bit=sec("feature_map"))
    if any(b <= a for a, b in zip(feats, feats[1:])):
        diag("TOAD005", "feature-map input indices are not strictly "
             "increasing (duplicate or unsorted used features)",
             section="feature_map", bit=sec("feature_map"))

    is_codebook = encoded.thr_codebook_bits > 0
    if not is_codebook:
        for i, (w, fl) in enumerate(zip(h["widths"], h["is_float"])):
            if w > 32 or (fl and w not in (16, 32)):
                diag("TOAD005", f"feature-map entry {i}: invalid threshold "
                     f"width {w} (float={fl})",
                     section="feature_map", bit=sec("feature_map"))

    # ---- walk the value sections with a fresh reader ---------------------
    try:
        r = BitReader(data, n_bits)
        r.read_array(1, sec("feature_map"))  # skip metadata
        r.read_array(1, so.sections["feature_map"][1] - sec("feature_map"))

        if is_codebook:
            n_cb = h["n_cb"]
            cb_ref_bits = h["cb_ref_bits"]
            table = r.read_f32_array(n_cb)
            if not np.all(np.isfinite(table)):
                diag("TOAD004", "threshold codebook contains non-finite "
                     "values", section="thr_codebook", bit=sec("thr_codebook"))
            elif np.any(np.diff(table) <= 0):
                diag("TOAD008", "threshold codebook table is not strictly "
                     "increasing (unsorted or duplicate entries)",
                     section="thr_codebook", bit=sec("thr_codebook"))
            if n_cb > 2 ** encoded.thr_codebook_bits:
                diag("TOAD008",
                     f"codebook has {n_cb} entries, over the nominal "
                     f"2^{encoded.thr_codebook_bits} cap (legitimate for "
                     f"per-feature scope; worth auditing)",
                     section="thr_codebook", bit=sec("thr_codebook"),
                     severity=WARNING)
            for i, c in enumerate(counts):
                at = r.pos
                refs = r.read_array(cb_ref_bits, c)
                if np.any(refs >= n_cb):
                    diag("TOAD007",
                         f"feature {feats[i]}: codebook ref "
                         f"{int(refs.max())} >= table size {n_cb}",
                         section="thresholds", bit=at)
                    continue  # resolved-order check is meaningless now
                vals = table[refs.astype(np.int64)] if n_cb else refs
                if np.any(np.diff(vals) < 0):
                    diag("TOAD006",
                         f"feature {feats[i]}: resolved threshold list is "
                         f"decreasing", section="thresholds", bit=at)
        else:
            for i, c in enumerate(counts):
                at = r.pos
                w, fl = h["widths"][i], h["is_float"][i]
                if w > 32 or (fl and w not in (16, 32)):
                    raise StreamBoundsError(
                        "cannot walk thresholds past an invalid width",
                        pos=at, width=w)
                if fl and w == 32:
                    vals = r.read_f32_array(c)
                elif fl:
                    vals = (r.read_array(16, c).astype(np.uint16)
                            .view(np.float16).astype(np.float32))
                else:
                    vals = r.read_array(w, c).astype(np.float64)
                if not np.all(np.isfinite(vals)):
                    diag("TOAD004", f"feature {feats[i]}: non-finite "
                         f"threshold value", section="thresholds", bit=at)
                elif np.any(np.diff(vals) < 0):
                    diag("TOAD006", f"feature {feats[i]}: threshold list is "
                         f"decreasing", section="thresholds", bit=at)

        leaf_at = r.pos
        leaf_vals = r.read_f32_array(max(h["n_leaf"], 1))
        if not np.all(np.isfinite(leaf_vals)):
            diag("TOAD004", "leaf-value table contains non-finite values",
                 section="leaf_table", bit=leaf_at)

        # ---- trees (TOAD009/TOAD010) ------------------------------------
        n_fu, fu_bits = h["n_fu"], h["fu_bits"]
        tidx_bits, leaf_bits = h["tidx_bits"], h["leaf_bits"]
        I = 2 ** h["D"] - 1
        L = 2 ** h["D"]
        counts_arr = np.asarray(counts, np.int64)
        for t in range(h["K"]):
            split = np.zeros(I, bool)
            tree_at = r.pos
            bad_node = False
            for i in range(I):
                ref = r.read(fu_bits)
                if ref == n_fu:
                    continue  # no-split sentinel
                if ref > n_fu:
                    if not bad_node:
                        diag("TOAD009", f"tree {t} node {i}: feature ref "
                             f"{ref} is neither a used feature nor the "
                             f"no-split sentinel {n_fu}",
                             section="trees", bit=tree_at)
                    bad_node = True
                    continue
                tix = r.read(tidx_bits)
                if tix >= counts_arr[ref]:
                    if not bad_node:
                        diag("TOAD009", f"tree {t} node {i}: threshold index "
                             f"{tix} >= feature count {int(counts_arr[ref])}",
                             section="trees", bit=tree_at)
                    bad_node = True
                split[i] = True
            # reachability: unsplit nodes route left, so a right child of an
            # unsplit (or dead) node can never be reached
            dead = np.zeros(I, bool)
            unreachable_split = False
            for i in range(1, I):
                p = (i - 1) // 2
                dead[i] = dead[p] or (i % 2 == 0 and not split[p])
                unreachable_split |= bool(split[i] and dead[i])
            if unreachable_split:
                diag("TOAD010", f"tree {t} contains splits in unreachable "
                     f"subtrees", section="trees", bit=tree_at)
            lrefs = r.read_array(leaf_bits, L)
            if np.any(lrefs >= max(h["n_leaf"], 1)):
                diag("TOAD009", f"tree {t}: leaf ref {int(lrefs.max())} >= "
                     f"leaf-table size {h['n_leaf']}",
                     section="trees", bit=tree_at)

        if r.remaining != 0:
            diag("TOAD002", f"{r.remaining} unconsumed bits after the trees "
                 f"section", section="trees", bit=r.pos)
    except StreamBoundsError as e:
        diag("TOAD001", f"stream truncated: {e}",
             section=so.section_at(max(e.pos, 0)), bit=max(e.pos, 0))

    return diags


# --------------------------------------------------------------------------
# Early-exit bound-table verification (TOAD12x)
# --------------------------------------------------------------------------


def _early_exit_table(ee, n_trees: int, n_ensembles: int, path: str,
                      diags: list[Diagnostic]) -> "np.ndarray | None":
    """Structurally validate a manifest ``early_exit`` section (TOAD121).

    Returns the parsed ``(n_trees + 1, n_ensembles)`` float64 bound table,
    or ``None`` after emitting a diagnostic if the section is malformed.
    An early exit decided against a bad table can silently change
    ``predict_label``, so every rule the decision relies on is enforced:
    shape, finiteness, non-negativity, monotone non-increasing columns and
    an all-zero final row.
    """

    def diag(message):
        diags.append(Diagnostic(code="TOAD121", message=message, file=path,
                                section="early_exit"))

    if not isinstance(ee, dict):
        diag("early_exit section is not a mapping")
        return None
    rm = ee.get("remaining_mass")
    if rm is None:
        diag("early_exit section has no remaining_mass table")
        return None
    try:
        table = np.asarray(rm, np.float64)
    except (TypeError, ValueError) as e:
        diag(f"remaining_mass does not parse as a float matrix: {e}")
        return None
    if table.ndim != 2 or table.shape != (n_trees + 1, n_ensembles):
        diag(f"remaining_mass has shape {table.shape}, expected "
             f"({n_trees + 1}, {n_ensembles}) for a {n_trees}-tree, "
             f"{n_ensembles}-class forest")
        return None
    if not np.all(np.isfinite(table)):
        diag("remaining_mass contains non-finite entries")
        return None
    if np.any(table < 0) or np.any(table[-1] != 0.0) or \
            np.any(np.diff(table, axis=0) > 0):
        diag("remaining_mass is not a non-negative, monotone non-increasing "
             "suffix table ending at zero — it cannot be a valid "
             "remaining-score-mass bound")
        return None
    policy = ee.get("policy")
    if policy is not None:
        from repro_torch.gbdt.early_exit import EarlyExitPolicy

        try:
            EarlyExitPolicy.from_dict(dict(policy))
        except (TypeError, ValueError, KeyError) as e:
            diag(f"early-exit policy does not parse: {e}")
            return None
    return table


def _compare_bound_table(table: np.ndarray, expect: np.ndarray, path: str,
                         diags: list[Diagnostic]) -> None:
    """TOAD120: shipped bound table vs one recomputed from the forest.

    The recompute uses the same fixed float64 summation order as the
    writer, so a genuine table matches far inside the tolerance; any
    mismatch means the manifest and the forest disagree about how much
    score the remaining trees can move — an exit decided against it is no
    longer provably label-safe.
    """
    err = (float(np.max(np.abs(table - expect) / (1.0 + np.abs(expect))))
           if table.size else 0.0)
    if err > 1e-9:
        diags.append(Diagnostic(
            code="TOAD120", file=path, section="early_exit",
            message=f"early_exit remaining_mass does not match the shipped "
                    f"forest (max relative error {err:.2e}) — exits decided "
                    f"against this table could change predict_label"))


# --------------------------------------------------------------------------
# Bundle-level verification
# --------------------------------------------------------------------------


def _check_forest_arrays(arrays: Mapping, n_ensembles: int, path: str,
                         diags: list[Diagnostic]) -> None:
    """Dense-array invariants (TOAD107): what every backend relies on."""

    def diag(message):
        diags.append(Diagnostic(code="TOAD107", message=message, file=path,
                                section="forest_arrays"))

    edges = np.asarray(arrays["edges"])
    K = int(np.asarray(arrays["n_trees"]))
    cap = arrays["feature"].shape[0]
    if not 0 <= K <= cap:
        diag(f"n_trees = {K} outside the [0, {cap}] tree capacity")
        K = min(max(K, 0), cap)
    V = int(np.asarray(arrays["n_leaf_values"]))
    if not 0 <= V <= arrays["leaf_values"].shape[0]:
        diag(f"n_leaf_values = {V} outside the leaf-table capacity "
             f"{arrays['leaf_values'].shape[0]}")
        V = min(max(V, 0), arrays["leaf_values"].shape[0])
    for f in range(edges.shape[0]):
        row = edges[f][np.isfinite(edges[f])]
        if np.any(np.diff(row) < 0):
            diag(f"edge row {f} is not sorted — the binned test "
                 f"bin<=e <=> x<=edges[e] no longer holds")
    if K:
        split = np.asarray(arrays["is_split"])[:K]
        feat = np.asarray(arrays["feature"])[:K]
        thr = np.asarray(arrays["thr_bin"])[:K]
        lref = np.asarray(arrays["leaf_ref"])[:K]
        if split.any():
            if feat[split].min() < 0 or feat[split].max() >= edges.shape[0]:
                diag(f"split feature index outside [0, {edges.shape[0]})")
            if thr[split].min() < 0 or thr[split].max() >= edges.shape[1]:
                diag(f"split threshold bin outside [0, {edges.shape[1]})")
        if lref.min() < 0 or lref.max() >= max(V, 1):
            diag(f"leaf ref outside [0, {max(V, 1)})")
    base = np.asarray(arrays["base_score"])
    if base.shape[0] != n_ensembles:
        diag(f"base_score has {base.shape[0]} entries for {n_ensembles} "
             f"ensembles")


def verify_bundle(meta: dict | None, arrays: Mapping,
                  path: str = "") -> list[Diagnostic]:
    """Structurally verify a ``.toad`` bundle (parsed meta + raw arrays).

    ``arrays`` is any ``str -> np.ndarray`` mapping — an open ``np.load``
    handle at load time, or the in-memory dict ``save_artifact`` is about
    to write.  No prediction is run; value-level drift stays the probe
    fingerprint's job.
    """
    diags: list[Diagnostic] = []

    def diag(code, message, severity="", section=""):
        diags.append(Diagnostic(code=code, message=message, file=path,
                                severity=severity, section=section))

    if meta is None:
        diag("TOAD101", "no meta_json: not a .toad artifact")
        return diags
    max_version = _max_format_version()
    version = int(meta.get("format_version", 1))
    if version < 1 or version > max_version:
        diag("TOAD102", f".toad format version {version} is not supported "
             f"by this runtime (max {max_version})")
        return diags

    missing = [k for k in FOREST_FIELDS if k not in arrays]
    if missing:
        diag("TOAD101", f"forest arrays missing from the bundle: {missing}")
        return diags
    n_ensembles = int(meta.get("n_ensembles", 1))
    _check_forest_arrays(arrays, n_ensembles, path, diags)

    encoded = None
    if "toad_stream" in arrays:
        cb_bits = (int(np.asarray(arrays["toad_stream_cb_bits"]))
                   if "toad_stream_cb_bits" in arrays else 0)
        encoded = EncodedModel(
            data=np.asarray(arrays["toad_stream"], np.uint8),
            n_bits=int(np.asarray(arrays["toad_stream_bits"])),
            thr_codebook_bits=cb_bits,
        )
        # version negotiation (TOAD103): codebook streams need a v3 reader;
        # classic streams stamped 3 lock out v2 runtimes for nothing
        if cb_bits > 0 and version < 3:
            diag("TOAD103", f"stream uses the threshold-codebook layout but "
                 f"the bundle is stamped version {version}; a version-"
                 f"{version} reader would mis-parse it")
        elif cb_bits == 0 and version >= 3:
            diag("TOAD103", f"classic stream stamped version {version}; the "
                 f"lowest sufficient version is 2", severity=WARNING)

        fp = meta.get("fingerprint") or {}
        if version >= 2:
            if fp.get("stream_sha256"):
                from repro_torch.api.artifact import stream_digest  # lazy: cycle

                if stream_digest(encoded) != fp["stream_sha256"]:
                    diag("TOAD106", "encoded-stream digest mismatch — the "
                         "ToaD bit stream is corrupted")
            else:
                diag("TOAD108", "bundle carries an encoded stream but no "
                     "stream_sha256 fingerprint", severity=WARNING)

        diags.extend(verify_stream(encoded, path=path))

    # ---- spec <-> stream agreement (TOAD105) -----------------------------
    spec = meta.get("spec")
    if spec is not None:
        from repro_torch.core.pipeline import CompressionSpec

        try:
            spec = CompressionSpec.from_dict(dict(spec))
        except Exception as e:  # malformed spec dict
            diag("TOAD101", f"spec does not parse as a CompressionSpec: {e}")
            spec = None
    if spec is not None and encoded is not None:
        spec_cb = ("threshold_codebook" in spec.stages)
        if spec_cb and encoded.thr_codebook_bits != spec.thr_codebook_bits:
            diag("TOAD105", f"spec says thr_codebook_bits="
                 f"{spec.thr_codebook_bits} but the stream carries "
                 f"{encoded.thr_codebook_bits}")
        elif not spec_cb and encoded.thr_codebook_bits > 0:
            diag("TOAD105", "stream uses the threshold-codebook layout but "
                 "the spec has no threshold_codebook stage")

    # ---- manifest byte accounting (TOAD104) ------------------------------
    manifest = meta.get("manifest")
    if manifest is not None:
        from repro_torch.gbdt.forest import forest_from_numpy

        forest = forest_from_numpy({f: arrays[f] for f in FOREST_FIELDS},
                                   n_ensembles, device="cpu")
        cb_bits = encoded.thr_codebook_bits if encoded is not None else int(
            manifest.get("thr_codebook_bits", 0))
        if int(manifest.get("thr_codebook_bits", 0)) != cb_bits:
            diag("TOAD104", f"manifest thr_codebook_bits = "
                 f"{manifest.get('thr_codebook_bits')} but the stream "
                 f"carries {cb_bits}")
        expect = stream_sections(forest, thr_codebook_bits=cb_bits)
        got = manifest.get("sections") or {}
        for key, val in expect.items():
            if key in got and abs(float(got[key]) - val) > 0.51:
                diag("TOAD104", f"manifest sections[{key!r}] = "
                     f"{float(got[key]):.1f} B but the shipped forest "
                     f"re-encodes to {val:.1f} B")
        if encoded is not None:
            if "encoded_stream_bits" in manifest and \
                    int(manifest["encoded_stream_bits"]) != encoded.n_bits:
                diag("TOAD104", f"manifest encoded_stream_bits = "
                     f"{manifest['encoded_stream_bits']} but the payload "
                     f"declares {encoded.n_bits}")
            if abs(expect["total_bytes"] - encoded.n_bytes) > 0.51 and \
                    not errors(diags):
                diag("TOAD104", f"shipped forest re-encodes to "
                     f"{expect['total_bytes']:.1f} B but the stream holds "
                     f"{encoded.n_bytes:.1f} B")

    # ---- early-exit bound table (TOAD120/TOAD121) ------------------------
    if "early_exit" in meta and not errors(diags):
        K = int(np.asarray(arrays["n_trees"]))
        table = _early_exit_table(meta["early_exit"], K, n_ensembles,
                                  path, diags)
        if table is not None:
            from types import SimpleNamespace

            from repro_torch.core.treeorder import remaining_mass

            duck = SimpleNamespace(
                n_trees=K,
                is_split=np.asarray(arrays["is_split"]),
                leaf_ref=np.asarray(arrays["leaf_ref"]),
                leaf_values=np.asarray(arrays["leaf_values"]),
                n_ensembles=n_ensembles,
            )
            _compare_bound_table(table, remaining_mass(duck), path, diags)
    return diags


# --------------------------------------------------------------------------
# Whole artifacts
# --------------------------------------------------------------------------


def verify_artifact(path: str) -> list[Diagnostic]:
    """Open a ``.toad`` file and structurally verify it.

    Dispatches on the leading magic bytes: a ``.toadpack`` streaming
    container raises ``NotImplementedError`` (its check, ``verify_pack``,
    comes with the streaming slice); everything else goes through the npz
    bundle path.
    """
    try:
        with open(path, "rb") as f:
            magic = f.read(8)
    except OSError as e:
        return [Diagnostic(code="TOAD101", file=path,
                           message=f"cannot open artifact: {e}")]
    if magic == PACK_MAGIC:
        raise NotImplementedError(
            f"{path}: a .toadpack streaming container; its check (verify_pack, "
            "TOAD110-TOAD114) comes with the port's streaming slice"
        )
    try:
        with np.load(path) as z:
            if "meta_json" not in z:
                return [Diagnostic(code="TOAD101", file=path,
                                   message="no meta_json: not a .toad "
                                           "artifact")]
            try:
                meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
            except (ValueError, UnicodeDecodeError) as e:
                return [Diagnostic(code="TOAD101", file=path,
                                   message=f"meta_json does not parse: {e}")]
            arrays = {k: z[k] for k in z.files}
    except (OSError, ValueError) as e:
        return [Diagnostic(code="TOAD101", file=path,
                           message=f"cannot open as an npz bundle: {e}")]
    return verify_bundle(meta, arrays, path=path)


def verify_model(model) -> list[Diagnostic]:
    """Verify an in-memory fitted :class:`~repro_torch.api.model.ToadModel`.

    What ``save_artifact`` runs post-encode: the same bundle-level checks
    against the arrays/meta it is about to write, so an encoder bug fails
    at the producer, not on a device.
    """
    from repro_torch.api.artifact import stream_digest  # lazy: import cycle
    from repro_torch.gbdt.forest import forest_to_numpy

    arrays = forest_to_numpy(model.forest)
    fingerprint = {}
    if model.encoded is not None:

        arrays["toad_stream"] = np.asarray(model.encoded.data, np.uint8)
        arrays["toad_stream_bits"] = np.asarray(model.encoded.n_bits)
        if model.encoded.thr_codebook_bits:
            arrays["toad_stream_cb_bits"] = np.asarray(
                model.encoded.thr_codebook_bits)
        fingerprint["stream_sha256"] = stream_digest(model.encoded)
    meta = {
        "fingerprint": fingerprint,
        "format_version": 3 if (model.encoded is not None and
                                model.encoded.thr_codebook_bits) else 2,
        "n_ensembles": model.forest.n_ensembles,
        "spec": model.spec.to_dict() if model.spec is not None else None,
    }
    return verify_bundle(meta, arrays, path="<in-memory model>")
