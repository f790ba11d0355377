"""Staged, pluggable compression: the ToaD lifecycle as a pipeline.

The port of ``repro.core.pipeline``.  The paper's 4-16x compression is a
*composition* of techniques — threshold width selection (Sec. 3.2.1),
shared leaf tables (Sec. 3.2.2), optional value quantization, and the
bit-packed memory layout itself — and this module makes that composition
a first-class object:

* :class:`CompressionStage` — one named transform or materialization step,
  registered via :func:`register_stage`.  Each stage reports
  ``(bytes_before, bytes_after, max_abs_pred_delta)`` into a
  :class:`CompressionReport`.
* :class:`CompressionSpec` — a declarative, JSON-serializable description
  of which stages run in which order, with their parameters.  The default
  spec reproduces the ``encode -> decode -> to_packed`` chain byte for
  byte.
* :func:`run_pipeline` — execute a spec against a trained forest.
* :func:`search_budget` — walk a *budget ladder* of specs (exact -> fp16
  leaves -> leaf codebooks interleaved with threshold codebooks) and return
  the first artifact that fits a byte budget; ``max_pred_delta`` also
  rejects rungs whose probe-set prediction drift exceeds it.

Built-in stages:

========================  ====================================================
``threshold_width``       per-feature threshold width selection
                          (``layout.select_width``); ``threshold_precision=
                          "f16"`` forces lossy fp16 edge rounding
``threshold_codebook``    k-means clustering of all split thresholds into a
                          single shared table of <= 2**bits entries
                          (globally or per feature); the stream switches to
                          the shared-table layout
``leaf_f16``              fp16-round the global leaf-value table and merge
                          now-identical entries
``leaf_codebook``         k-means codebook quantization of the leaf table
                          (``core.codebook``)
``encode``                bit-stream serialization (``core.layout.encode``)
``pack``                  decoded arrays + uint32 node words
                          (``decode`` + ``to_packed``), the serving form
========================  ====================================================

The transforms work on host numpy copies of the forest, as the JAX
package's do (float16 rounding through numpy, ``np.unique``,
``np.searchsorted`` on the codebook midpoints, the codebooks from
``core.codebook.quantize`` on the CPU), and put the new forest's tensors
back on the forest's device.  So the same forest gives the same encoded
bytes here as in the JAX package, and on the card as on the CPU.  Lossy
stages measure their prediction drift with ``predict_raw`` on the forest's
device, over a deterministic probe set derived from the model's own bin
edges (no dataset needed); on the card its sums run in another order than
on the CPU, so a drift can differ in its last bits between the two.
"""

from __future__ import annotations

import abc
import dataclasses
import json

import numpy as np
import torch

from repro_torch.core.bitio import bits_for
from repro_torch.core.codebook import quantize
from repro_torch.core.layout import (
    DecodedModel,
    EncodedModel,
    PackedEnsemble,
    _used_sets,
    decode,
    encode,
    select_width,
    to_packed,
    used_threshold_values,
)
from repro_torch.gbdt.forest import Forest, forest_to_numpy, predict_raw

DEFAULT_STAGES = ("threshold_width", "encode", "pack")


# --------------------------------------------------------------------------
# Spec
# --------------------------------------------------------------------------


# Spec fields added after the v2 .toad format shipped.  ``to_dict`` omits
# them at their default values so artifacts that don't use the threshold
# codebook keep a spec dict that pre-existing runtimes can parse.
_POST_V2_SPEC_DEFAULTS = {"thr_codebook_bits": 6, "thr_codebook_scope": "global"}


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Declarative description of one compression plan (JSON-serializable)."""

    stages: tuple[str, ...] = DEFAULT_STAGES
    threshold_precision: str = "auto"  # auto (lossless widths) | f16 (forced)
    codebook_bits: int = 4
    codebook_iters: int = 8
    name: str = "exact"
    thr_codebook_bits: int = 6
    thr_codebook_scope: str = "global"  # global | per_feature

    # ------------------------------------------------------------- builders
    @classmethod
    def exact(cls) -> "CompressionSpec":
        """The historical default: lossless widths, encode, pack."""
        return cls()

    @classmethod
    def fp16_leaves(cls) -> "CompressionSpec":
        return cls(
            stages=("threshold_width", "leaf_f16", "encode", "pack"),
            name="fp16-leaves",
        )

    @classmethod
    def codebook(cls, bits: int = 4, iters: int = 8) -> "CompressionSpec":
        return cls(
            stages=("threshold_width", "leaf_codebook", "encode", "pack"),
            codebook_bits=bits,
            codebook_iters=iters,
            name=f"codebook-{bits}bit",
        )

    @classmethod
    def thr_codebook(
        cls, bits: int = 6, scope: str = "global", iters: int = 8
    ) -> "CompressionSpec":
        """Shared threshold table only; the leaf table stays exact."""
        suffix = "" if scope == "global" else "-pf"
        return cls(
            stages=("threshold_codebook", "encode", "pack"),
            thr_codebook_bits=bits,
            thr_codebook_scope=scope,
            codebook_iters=iters,
            name=f"thr-codebook-{bits}bit{suffix}",
        )

    @classmethod
    def codebook_full(
        cls,
        thr_bits: int = 6,
        leaf_bits: int = 4,
        scope: str = "global",
        iters: int = 8,
    ) -> "CompressionSpec":
        """Both shared tables codebook-quantized (LIMITS-style layout)."""
        return cls(
            stages=("threshold_codebook", "leaf_codebook", "encode", "pack"),
            thr_codebook_bits=thr_bits,
            thr_codebook_scope=scope,
            codebook_bits=leaf_bits,
            codebook_iters=iters,
            name=f"codebook-t{thr_bits}l{leaf_bits}",
        )

    # ----------------------------------------------------------------- json
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["stages"] = list(d["stages"])
        for k, default in _POST_V2_SPEC_DEFAULTS.items():
            if d[k] == default:
                del d[k]
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "CompressionSpec":
        d = dict(d)
        d["stages"] = tuple(d.get("stages", DEFAULT_STAGES))
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "CompressionSpec":
        return cls.from_dict(json.loads(s))


# --------------------------------------------------------------------------
# Reports
# --------------------------------------------------------------------------


@dataclasses.dataclass
class StageReport:
    stage: str
    bytes_before: float
    bytes_after: float
    max_abs_pred_delta: float
    info: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CompressionReport:
    """What the pipeline did: per-stage sizes and prediction deltas.

    ``n_bytes`` is the final encoded-stream size; ``max_abs_pred_delta`` is
    the end-to-end prediction drift of the compressed forest vs the exact
    forest on the probe set (0.0 for lossless specs).  When produced by
    :func:`search_budget`, ``budget_bytes`` / ``fits`` / ``ladder`` explain
    which plans were tried and what was traded.
    """

    spec: CompressionSpec
    stages: list[StageReport]
    bytes_initial: float
    n_bytes: float
    packed_bytes: float
    max_abs_pred_delta: float
    budget_bytes: float | None = None
    fits: bool | None = None
    ladder: list[dict] = dataclasses.field(default_factory=list)
    max_pred_delta: float | None = None  # accuracy floor the search ran under

    @property
    def ratio(self) -> float:
        return self.bytes_initial / max(self.n_bytes, 1e-9)

    def as_dict(self) -> dict:
        return {
            "spec": self.spec.to_dict(),
            "stages": [s.as_dict() for s in self.stages],
            "bytes_initial": self.bytes_initial,
            "n_bytes": self.n_bytes,
            "packed_bytes": self.packed_bytes,
            "max_abs_pred_delta": self.max_abs_pred_delta,
            "budget_bytes": self.budget_bytes,
            "fits": self.fits,
            "ladder": list(self.ladder),
            "max_pred_delta": self.max_pred_delta,
        }

    def summary(self) -> str:
        lines = [
            f"spec {self.spec.name!r}: {self.bytes_initial:.0f} B -> "
            f"{self.n_bytes:.0f} B encoded "
            f"(max|Δpred| {self.max_abs_pred_delta:.2e})"
        ]
        for s in self.stages:
            lines.append(
                f"  {s.stage:16s} {s.bytes_before:8.0f} -> {s.bytes_after:8.0f} B"
                f"   max|Δpred| {s.max_abs_pred_delta:.2e}"
            )
        if self.budget_bytes is not None:
            floor = (
                "" if self.max_pred_delta is None
                else f", max|Δpred| <= {self.max_pred_delta:g}"
            )
            lines.append(
                f"  budget {self.budget_bytes:.0f} B{floor}: "
                + ("fits" if self.fits else "DOES NOT FIT")
            )
            for rung in self.ladder:
                note = "" if rung.get("accuracy_ok", True) else "  (over floor)"
                lines.append(
                    f"    tried {rung['spec']:16s} {rung['n_bytes']:8.0f} B"
                    f" {'<=' if rung['fits'] else '>'} budget{note}"
                )
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Probe inputs + prediction helper (for lossy-stage deltas)
# --------------------------------------------------------------------------


def probe_inputs(forest: Forest, n: int = 64, seed: int = 0) -> np.ndarray:
    """Deterministic (n, d) raw-feature probe derived from the bin edges.

    Per feature, rows are drawn uniformly over [min_edge - 1, max_edge + 1]
    (standard normal when a feature has no finite candidate edge), so every
    threshold is straddled.  numpy draws it, so the JAX package and the port
    probe with the same rows.
    """
    rng = np.random.default_rng(seed)
    edges = forest.edges.detach().cpu().numpy()
    d = edges.shape[0]
    x = rng.standard_normal((n, d)).astype(np.float32)
    for f in range(d):
        finite = edges[f][np.isfinite(edges[f])]
        if finite.size:
            lo, hi = float(finite.min()) - 1.0, float(finite.max()) + 1.0
            x[:, f] = rng.uniform(lo, hi, size=n).astype(np.float32)
    return x


def _predict(forest: Forest, probe: np.ndarray) -> np.ndarray:
    """Reference scores of ``forest`` on host rows, on the forest's device."""
    x = torch.as_tensor(probe, dtype=torch.float32, device=forest.device)
    return predict_raw(forest, x).cpu().numpy()


# --------------------------------------------------------------------------
# Stage protocol + registry
# --------------------------------------------------------------------------


class PipelineContext:
    """Mutable state threaded through the stages of one pipeline run."""

    def __init__(self, forest: Forest, spec: CompressionSpec, probe=None):
        self.forest = forest
        self.spec = spec
        self.encoded: EncodedModel | None = None
        self.decoded: DecodedModel | None = None
        self.packed: PackedEnsemble | None = None
        # set by the threshold_codebook stage; encode() then emits the
        # shared-table stream layout instead of per-feature widths
        self.thr_codebook_bits = 0
        self._probe = probe
        self._sb_forest = None
        self._sb_cb = 0
        self._sb_encoded: EncodedModel | None = None

    @property
    def probe(self) -> np.ndarray:
        if self._probe is None:
            self._probe = probe_inputs(self.forest)
        return self._probe

    def stream(self) -> EncodedModel:
        """Encoded stream of the *current* forest and stream layout
        (memoized per (forest, thr_codebook_bits))."""
        if self._sb_forest is not self.forest or self._sb_cb != self.thr_codebook_bits:
            self._sb_encoded = encode(
                self.forest, thr_codebook_bits=self.thr_codebook_bits
            )
            self._sb_forest = self.forest
            self._sb_cb = self.thr_codebook_bits
        return self._sb_encoded

    def stream_bytes(self) -> float:
        return self.stream().n_bytes


class CompressionStage(abc.ABC):
    """One named step of the compression pipeline.

    ``apply`` mutates the context (replacing ``ctx.forest`` for transform
    stages, filling ``ctx.encoded``/``ctx.decoded``/``ctx.packed`` for
    materialization stages) and returns an info dict for the stage report.
    ``lossless`` declares whether the stage can change predictions; lossy
    stages get their ``max_abs_pred_delta`` measured on the probe set.
    """

    name: str = "?"

    def is_lossless(self, spec: CompressionSpec) -> bool:
        """Whether the stage can change predictions under this spec."""
        return True

    @abc.abstractmethod
    def apply(self, ctx: PipelineContext) -> dict:
        """Run the stage; return report info."""


_STAGES: dict[str, CompressionStage] = {}


def register_stage(cls: type[CompressionStage]) -> type[CompressionStage]:
    """Class decorator: instantiate and register under ``cls.name``."""
    _STAGES[cls.name] = cls()
    return cls


def get_stage(name: str) -> CompressionStage:
    try:
        return _STAGES[name]
    except KeyError:
        raise KeyError(
            f"unknown compression stage {name!r}; registered: "
            f"{', '.join(sorted(_STAGES))}"
        ) from None


def list_stages() -> list[str]:
    return sorted(_STAGES)


# --------------------------------------------------------------------------
# Pure forest transforms (host numpy; the result on the forest's device)
# --------------------------------------------------------------------------


def _on_device(forest: Forest, **arrays) -> Forest:
    """``forest`` with the given host arrays replaced, on its device in its
    dtypes."""
    return dataclasses.replace(forest, **{
        k: torch.from_numpy(np.array(v)).to(forest.device, getattr(forest, k).dtype)
        for k, v in arrays.items()
    })


def fp16_edges(forest: Forest) -> Forest:
    """fp16-round every candidate threshold (bin edge)."""
    edges = forest.edges.detach().cpu().numpy()
    return _on_device(forest, edges=edges.astype(np.float16).astype(np.float32))


def fp16_leaf_values(forest: Forest) -> Forest:
    """fp16-round the global leaf-value table."""
    values = forest.leaf_values.detach().cpu().numpy()
    return _on_device(forest, leaf_values=values.astype(np.float16).astype(np.float32))


def _rebuild_leaf_table(forest: Forest, new_values: np.ndarray, a: dict) -> Forest:
    """Replace slot ``i`` of the used leaf table with ``new_values[i]``,
    merging now-equal entries (shared-value-table semantics: the table only
    stores *distinct* values) and remapping every leaf reference.  ``a``
    holds the forest's host arrays."""
    V = int(a["n_leaf_values"])
    uniq, inverse = np.unique(new_values.astype(np.float32), return_inverse=True)
    mapping = inverse.reshape(-1).astype(np.int32)  # old ref -> new ref
    old_ref = np.clip(a["leaf_ref"], 0, V - 1)
    table = np.zeros(a["leaf_values"].shape, np.float32)
    table[: len(uniq)] = uniq
    return _on_device(forest, leaf_values=table, leaf_ref=mapping[old_ref],
                      n_leaf_values=np.asarray(len(uniq), np.int32))


def fp16_leaf_table(forest: Forest) -> Forest:
    """fp16-round the leaf table *and* merge now-identical entries.

    This is what the ``leaf_f16`` stage runs: unlike the plain rounding
    (:func:`fp16_leaf_values`), merging shrinks both the global table and
    the per-leaf reference width in the encoded stream.  Predictions are
    identical to plain rounding — merging is value-exact.
    """
    a = forest_to_numpy(forest)
    V = int(a["n_leaf_values"])
    if V == 0:
        return forest
    rounded = a["leaf_values"][:V].astype(np.float16).astype(np.float32)
    return _rebuild_leaf_table(forest, rounded, a)


def codebook_thresholds(
    forest: Forest, bits: int = 6, iters: int = 8, scope: str = "global"
) -> Forest:
    """Cluster split thresholds into a shared table of ``<= 2**bits`` values.

    With ``scope="global"`` one k-means codebook covers every used feature;
    ``"per_feature"`` clusters each feature's thresholds separately (each
    feature keeps ``<= 2**bits`` distinct values, but the union table may
    exceed ``2**bits`` entries).

    The transform (a) snaps each used feature's *entire* edge row through
    the monotone nearest-centroid map, so rows stay sorted and the binned
    test ``bin <= e  <=>  x <= edges[e]`` keeps holding, and (b) remaps
    every split's ``thr_bin`` to the first edge slot holding its snapped
    value, so edges that collapsed to the same centroid share one id.  A
    feature whose distinct used values already fit the table is snapped to
    itself (identity).  Lossy: splits move to centroid thresholds.
    """
    if scope not in ("global", "per_feature"):
        raise ValueError(f"thr_codebook_scope must be global|per_feature, got {scope!r}")
    if not 2 <= bits <= 16:
        raise ValueError(f"thr_codebook_bits must be in [2, 16], got {bits}")
    a = forest_to_numpy(forest)
    features, thr_by_feat = _used_sets(a)
    if not features:
        return forest

    edges = np.asarray(a["edges"], dtype=np.float32).copy()

    def centroids(vals: np.ndarray) -> np.ndarray:
        vals = np.unique(vals.astype(np.float32))
        if len(vals) <= 2**bits:
            return vals  # already fits: identity snap
        cb, _ = quantize(torch.from_numpy(vals), bits=bits, iters=iters)
        return np.unique(cb.numpy().astype(np.float32))

    if scope == "global":
        shared = centroids(
            np.concatenate([edges[f, thr_by_feat[f]] for f in features])
        )
        tables = {f: shared for f in features}
    else:
        tables = {f: centroids(edges[f, thr_by_feat[f]]) for f in features}

    thr_bin = a["thr_bin"].copy()
    feat_arr = a["feature"]
    split_arr = a["is_split"]
    for f in features:
        cb = tables[f]
        row = edges[f]
        finite = np.isfinite(row)
        if len(cb) == 1:
            row[finite] = cb[0]
        else:
            mids = (cb[1:] + cb[:-1]) / 2.0
            row[finite] = cb[np.searchsorted(mids, row[finite])]
        # canonical id per slot: the first slot holding the same value
        canon = np.searchsorted(row, row, side="left").astype(np.int32)
        mask = split_arr & (feat_arr == f)
        safe = np.clip(thr_bin, 0, len(canon) - 1)
        thr_bin = np.where(mask, canon[safe], thr_bin)

    return _on_device(forest, edges=edges, thr_bin=thr_bin)


def codebook_leaf_values(forest: Forest, bits: int = 4, iters: int = 8) -> Forest:
    """k-means codebook quantization of the shared leaf table.

    Replaces the ``V``-entry leaf table with at most ``2**bits`` distinct
    centroid values and remaps every leaf reference, so the encoded stream
    pays ``<= 2**bits`` fp32 table entries and ``bits``-wide references
    instead of ``ceil(log2 V)``.  A table already at or below ``2**bits``
    distinct values is returned unchanged.
    """
    a = forest_to_numpy(forest)
    V = int(a["n_leaf_values"])
    if V == 0 or V <= 2**bits:
        return forest
    values = a["leaf_values"][:V]
    cb, idx = quantize(torch.from_numpy(values), bits=bits, iters=iters)
    snapped = cb.numpy()[idx.numpy().astype(np.int64)]  # (V,) centroid per slot
    return _rebuild_leaf_table(forest, snapped, a)


# --------------------------------------------------------------------------
# Built-in stages
# --------------------------------------------------------------------------


@register_stage
class ThresholdWidthStage(CompressionStage):
    """Per-feature threshold width selection (paper Sec. 3.2.1 (b)-(c)).

    ``threshold_precision="auto"`` records the widths ``layout.encode`` will
    choose (lossless by construction: a width is only picked when every
    threshold round-trips exactly).  ``"f16"`` additionally *forces* fp16
    rounding of the edges — the lossy half of the paper's "quantized
    LightGBM" baseline — which lets every float feature take the 16-bit row.
    """

    name = "threshold_width"

    def is_lossless(self, spec: CompressionSpec) -> bool:
        return spec.threshold_precision == "auto"

    def apply(self, ctx: PipelineContext) -> dict:
        mode = ctx.spec.threshold_precision
        if mode not in ("auto", "f16"):
            raise ValueError(f"threshold_precision must be auto|f16, got {mode!r}")
        if mode == "f16":
            ctx.forest = fp16_edges(ctx.forest)
        a = forest_to_numpy(ctx.forest)
        features, thr_by_feat = _used_sets(a)
        edges = a["edges"]
        widths: dict[str, int] = {}
        for f in features:
            w, is_float = select_width(edges[f, thr_by_feat[f]])
            key = f"f{w}" if is_float else f"i{w}"
            widths[key] = widths.get(key, 0) + 1
        return {"precision": mode, "n_used_features": len(features),
                "width_histogram": widths}


@register_stage
class ThresholdCodebookStage(CompressionStage):
    """Shared threshold codebook: one table, bits-wide refs (LIMITS-style).

    Besides transforming the forest (``codebook_thresholds``), the stage
    flips the pipeline's stream layout to the shared-table variant, so the
    subsequent ``encode`` emits the codebook sections and every byte figure
    downstream (reports, budget rungs, manifests) reflects the new layout.
    """

    name = "threshold_codebook"

    def is_lossless(self, spec: CompressionSpec) -> bool:
        return False

    def apply(self, ctx: PipelineContext) -> dict:
        before = len(used_threshold_values(ctx.forest))
        ctx.forest = codebook_thresholds(
            ctx.forest,
            bits=ctx.spec.thr_codebook_bits,
            iters=ctx.spec.codebook_iters,
            scope=ctx.spec.thr_codebook_scope,
        )
        ctx.thr_codebook_bits = ctx.spec.thr_codebook_bits
        after = len(used_threshold_values(ctx.forest))
        return {
            "bits": ctx.spec.thr_codebook_bits,
            "scope": ctx.spec.thr_codebook_scope,
            "n_thresholds_before": before,
            "n_thresholds_after": after,
            "thr_ref_bits": bits_for(max(after, 1)),
        }


@register_stage
class LeafF16Stage(CompressionStage):
    """fp16-round the leaf table and merge now-identical entries."""

    name = "leaf_f16"

    def is_lossless(self, spec: CompressionSpec) -> bool:
        return False

    def apply(self, ctx: PipelineContext) -> dict:
        before = int(ctx.forest.n_leaf_values)
        ctx.forest = fp16_leaf_table(ctx.forest)
        return {
            "n_leaf_values_before": before,
            "n_leaf_values_after": int(ctx.forest.n_leaf_values),
        }


@register_stage
class LeafCodebookStage(CompressionStage):
    """k-means codebook quantization of the leaf table (core.codebook)."""

    name = "leaf_codebook"

    def is_lossless(self, spec: CompressionSpec) -> bool:
        return False

    def apply(self, ctx: PipelineContext) -> dict:
        before = int(ctx.forest.n_leaf_values)
        ctx.forest = codebook_leaf_values(
            ctx.forest, bits=ctx.spec.codebook_bits, iters=ctx.spec.codebook_iters
        )
        after = int(ctx.forest.n_leaf_values)
        return {
            "bits": ctx.spec.codebook_bits,
            "n_leaf_values_before": before,
            "n_leaf_values_after": after,
            "leaf_ref_bits": bits_for(max(after, 1)),
        }


@register_stage
class EncodeStage(CompressionStage):
    """Serialize the (possibly transformed) forest to the ToaD bit stream."""

    name = "encode"

    def apply(self, ctx: PipelineContext) -> dict:
        ctx.encoded = ctx.stream()
        return {"n_bits": ctx.encoded.n_bits}


@register_stage
class PackStage(CompressionStage):
    """Materialize the serving arrays: decode + uint32 node-word packing."""

    name = "pack"

    def apply(self, ctx: PipelineContext) -> dict:
        if ctx.encoded is None:
            raise ValueError("'pack' requires 'encode' earlier in the spec")
        ctx.decoded = decode(ctx.encoded)
        ctx.packed = to_packed(ctx.decoded)
        return {"packed_bytes": packed_nbytes(ctx.packed)}


def packed_nbytes(packed: PackedEnsemble) -> float:
    """Host-RAM footprint of the packed serving arrays, in bytes."""
    return float(
        sum(
            np.asarray(getattr(packed, f)).nbytes
            for f in ("words", "leaf_ref", "leaf_values", "thr_table",
                      "thr_offsets", "used_features", "base_score")
        )
    )


# --------------------------------------------------------------------------
# Pipeline execution
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PipelineResult:
    forest: Forest
    encoded: EncodedModel | None
    decoded: DecodedModel | None
    packed: PackedEnsemble | None
    report: CompressionReport


def run_pipeline(
    forest: Forest,
    spec: CompressionSpec | None = None,
    probe=None,
    base_encoded: EncodedModel | None = None,
) -> PipelineResult:
    """Execute ``spec`` against a trained forest.

    Lossless specs never touch the probe (the default spec costs exactly one
    encode); lossy stages measure ``max_abs_pred_delta`` on the probe set.
    ``base_encoded`` optionally seeds the stream cache with an already
    encoded copy of ``forest`` (the budget ladder encodes the base exactly
    once across all rungs).
    """
    spec = spec or CompressionSpec.exact()
    stages = [get_stage(s) for s in spec.stages]  # fail fast on typos
    ctx = PipelineContext(forest, spec, probe=probe)
    if base_encoded is not None:
        ctx._sb_forest, ctx._sb_encoded = forest, base_encoded
        ctx._sb_cb = base_encoded.thr_codebook_bits
    bytes_initial = ctx.stream_bytes()
    preds_exact = None

    reports: list[StageReport] = []
    cur_bytes = bytes_initial
    for stage in stages:
        before_forest = ctx.forest
        before_cb = ctx.thr_codebook_bits
        lossless = stage.is_lossless(spec)
        preds_before = None
        if not lossless:
            if preds_exact is None:
                preds_exact = _predict(forest, ctx.probe)
            preds_before = (
                preds_exact if before_forest is forest else _predict(before_forest, ctx.probe)
            )
        info = stage.apply(ctx)
        changed = (
            ctx.forest is not before_forest or ctx.thr_codebook_bits != before_cb
        )
        if stage.name == "encode":
            after_bytes = ctx.encoded.n_bytes
        elif stage.name == "pack":
            after_bytes = packed_nbytes(ctx.packed)
        else:
            after_bytes = ctx.stream_bytes() if changed else cur_bytes
        delta = 0.0
        if preds_before is not None and ctx.forest is not before_forest:
            delta = float(np.abs(_predict(ctx.forest, ctx.probe) - preds_before).max())
        reports.append(
            StageReport(
                stage=stage.name,
                bytes_before=cur_bytes,
                bytes_after=after_bytes,
                max_abs_pred_delta=delta,
                info=info,
            )
        )
        if stage.name not in ("encode", "pack"):
            cur_bytes = after_bytes

    total_delta = 0.0
    if ctx.forest is not forest:
        if preds_exact is None:
            preds_exact = _predict(forest, ctx.probe)
        total_delta = float(np.abs(_predict(ctx.forest, ctx.probe) - preds_exact).max())

    report = CompressionReport(
        spec=spec,
        stages=reports,
        bytes_initial=bytes_initial,
        n_bytes=ctx.encoded.n_bytes if ctx.encoded is not None else cur_bytes,
        packed_bytes=packed_nbytes(ctx.packed) if ctx.packed is not None else 0.0,
        max_abs_pred_delta=total_delta,
    )
    return PipelineResult(
        forest=ctx.forest,
        encoded=ctx.encoded,
        decoded=ctx.decoded,
        packed=ctx.packed,
        report=report,
    )


# --------------------------------------------------------------------------
# Budget-targeted search
# --------------------------------------------------------------------------


def default_ladder() -> tuple[CompressionSpec, ...]:
    """Ordered plans from exact to most aggressive (LIMITS-style ladder).

    Threshold-codebook rungs are interleaved with the leaf-only rungs: at
    every leaf bit-width the next-more-aggressive plan also shares the
    threshold table, so trained-in reuse (penalties) and both post-hoc
    codebooks compose inside one budget search.
    """
    return (
        CompressionSpec.exact(),
        CompressionSpec.fp16_leaves(),
        CompressionSpec.codebook(6),
        CompressionSpec.codebook_full(6, 6),
        CompressionSpec.codebook(4),
        CompressionSpec.codebook_full(5, 4),
        CompressionSpec.codebook(3),
        CompressionSpec.codebook_full(4, 3),
        CompressionSpec.codebook(2),
        CompressionSpec.codebook_full(3, 2),
    )


def search_budget(
    forest: Forest,
    budget_bytes: float,
    ladder: tuple[CompressionSpec, ...] | None = None,
    probe=None,
    max_pred_delta: float | None = None,
) -> PipelineResult:
    """Return the first ladder plan whose encoded stream fits the budget.

    ``max_pred_delta`` adds an accuracy floor: a rung whose probe-set
    prediction drift exceeds it is rejected even when its bytes fit, so the
    search optimizes under *two* gates (size and quality), not size alone.
    The winning result's report carries the full ladder trace (every tried
    spec with its size, drift, and per-gate verdicts), so the trade is
    auditable.  Raises ``ValueError`` when no rung passes both gates, or
    when a (custom) ladder rung lacks the ``encode`` stage — a rung without
    it has no stream to measure against the budget.
    """
    ladder = ladder or default_ladder()
    for spec in ladder:
        if "encode" not in spec.stages:
            raise ValueError(
                f"ladder spec {spec.name!r} has no 'encode' stage "
                f"(stages={spec.stages}); every rung must produce an "
                f"encoded stream to compare against the budget"
            )
    if probe is None:
        probe = probe_inputs(forest)
    base_encoded = encode(forest)  # shared across rungs: encode base once
    tried: list[dict] = []
    for spec in ladder:
        res = run_pipeline(forest, spec, probe=probe, base_encoded=base_encoded)
        nb = res.encoded.n_bytes
        fits = nb <= budget_bytes
        delta = res.report.max_abs_pred_delta
        accuracy_ok = max_pred_delta is None or delta <= max_pred_delta
        tried.append(
            {
                "spec": spec.name,
                "n_bytes": nb,
                "fits": fits,
                "max_abs_pred_delta": delta,
                "accuracy_ok": accuracy_ok,
            }
        )
        if fits and accuracy_ok:
            res.report.budget_bytes = float(budget_bytes)
            res.report.fits = True
            res.report.ladder = tried
            res.report.max_pred_delta = max_pred_delta
            return res
    sizes = ", ".join(
        f"{t['spec']}={t['n_bytes']:.0f}B"
        + ("" if t["accuracy_ok"] else f" (Δpred {t['max_abs_pred_delta']:.1e} over floor)")
        for t in tried
    )
    floor = (
        "" if max_pred_delta is None
        else f" under accuracy floor max_pred_delta={max_pred_delta:g}"
    )
    raise ValueError(
        f"no compression plan fits budget_bytes={budget_bytes:.0f}{floor}: "
        f"{sizes}. Train a smaller model (toad_forestsize), relax the floor, "
        f"or pass a custom ladder."
    )
