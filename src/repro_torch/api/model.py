"""``ToadModel`` — the estimator facade, on a device.

    model = ToadModel(task="binary", n_bins=32, n_rounds=12, max_depth=3,
                      toad_penalty_feature=1.0, toad_penalty_threshold=0.5)
    model.fit(X, y).compress()                 # trains on the card
    model.compress(budget_bytes=4096)          # the first ladder rung under 4 KB
    scores = model.predict(X)                  # auto backend: cuda on an H100
    scores = model.predict(X, backend="packed")
    model.save("model.toad");  ToadModel.load("model.toad")

``fit`` bins ``X`` (quantile edges on the host, ``apply_bins`` on the
device) and trains with ``gbdt.trainer.train`` on the model's device;
``history`` and ``aux`` keep the trainer's per-round record and side
outputs.  ``predict`` returns the raw (n, C) ensemble margins;
``predict_proba`` / ``predict_label`` apply the task's link function on
top, ``score`` the task's metric.  The model lives on ``device`` (default
``"cuda"``; ``"cpu"`` only when asked for).  ``compress`` runs the staged
compression pipeline (``core.pipeline``): a spec, or the budget ladder
under ``budget_bytes`` (and ``max_pred_delta``), with the JAX package's
argument rules; its codebooks are made on the host, so a model on the
card compresses to the same bytes as on the CPU.  ``save`` and ``load``
run toadcheck (``analysis.verify``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.api.backends import PredictorBackend, resolve_backend
from repro_torch.core.layout import EncodedModel
from repro_torch.core.memory import compression_summary, reuse_factor
from repro_torch.core.pipeline import (
    CompressionReport,
    CompressionSpec,
    run_pipeline,
    search_budget,
)
from repro_torch.gbdt.binning import apply_bins, fit_bins
from repro_torch.gbdt.forest import FOREST_FIELDS, Forest
from repro_torch.gbdt.losses import make_loss
from repro_torch.gbdt.trainer import GBDTConfig, train


class NotFittedError(RuntimeError):
    pass


class ToadModel:
    """Estimator facade: fit / compress / predict / save / load /
    memory_report."""

    def __init__(
        self,
        task: str = "regression",
        n_classes: int = 0,
        n_bins: int = 64,
        config: GBDTConfig | None = None,
        device="cuda",
        **config_kwargs,
    ):
        if config is None:
            config = GBDTConfig(task=task, n_classes=n_classes, **config_kwargs)
        elif config_kwargs:
            config = dataclasses.replace(config, **config_kwargs)
        self.config = config
        self.n_bins = n_bins
        self.device = resolve_device(device)
        self.forest: Forest | None = None
        self.history: dict | None = None
        self.aux: dict | None = None
        self.encoded: EncodedModel | None = None
        self.decoded = None
        self.packed = None
        self.spec: CompressionSpec | None = None
        self.compression_report: CompressionReport | None = None
        self.artifact_meta: dict | None = None
        #: optional EarlyExitPolicy written into the .toad meta; a serving
        #: preference, not fit state, so refits and recompression keep it
        self.early_exit_policy = None
        self._forest_exact: Forest | None = None
        self._device_packed = None
        self._predict_fns: dict[str, object] = {}
        self._loss = make_loss(config.task, config.n_classes)

    @classmethod
    def from_forest(
        cls,
        forest: Forest,
        config: GBDTConfig | None = None,
        n_bins: int | None = None,
        device="cuda",
    ) -> "ToadModel":
        """Wrap an already-trained :class:`Forest` (moved to ``device``)."""
        if config is None:
            task = "multiclass" if forest.n_ensembles > 1 else "regression"
            config = GBDTConfig(task=task, n_classes=forest.n_ensembles)
        model = cls(config=config, n_bins=n_bins or forest.n_bins, device=device)
        model.forest = Forest(
            **{f: getattr(forest, f).to(model.device) for f in FOREST_FIELDS},
            n_ensembles=forest.n_ensembles,
        )
        return model

    # ------------------------------------------------------------- lifecycle
    @property
    def is_fitted(self) -> bool:
        return self.forest is not None

    @property
    def is_compressed(self) -> bool:
        return self.packed is not None

    def _require_fitted(self):
        if not self.is_fitted:
            raise NotFittedError("call fit() (or load()) before this operation")

    def fit(self, X, y) -> "ToadModel":
        """Bin ``X``, train the ToaD-regularised GBDT on the model's device,
        keep the history."""
        X = np.asarray(X, dtype=np.float32)
        edges = torch.from_numpy(fit_bins(X, self.n_bins)).to(self.device)
        bins = apply_bins(torch.from_numpy(X).to(self.device), edges)
        return self.fit_binned(bins, y, edges)

    def fit_binned(self, bins, y, edges) -> "ToadModel":
        """Train from pre-binned features + edges (skips the binning pass)."""
        def on_device(a, dtype=None):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, dtype))
            return t.to(self.device)

        bins = on_device(bins)
        y = on_device(y, np.float32).float()
        edges = on_device(edges, np.float32).float()
        self.forest, self.history, self.aux = train(self.config, bins, y, edges)
        self._reset_artifacts()  # fitted state changed
        return self

    def _reset_artifacts(self):
        """Drop built predictors and compression artifacts (state changed)."""
        self.encoded = self.decoded = self.packed = None
        self.spec = self.compression_report = self.artifact_meta = None
        self._forest_exact = None
        self._device_packed = None
        self._predict_fns.clear()

    def compress(
        self,
        spec: CompressionSpec | dict | str | None = None,
        budget_bytes: float | None = None,
        probe=None,
        max_pred_delta: float | None = None,
    ) -> "ToadModel":
        """Run the staged compression pipeline and keep its artifacts.

        With no arguments this is the lossless chain (encode -> bit stream,
        decode -> dense arrays, to_packed -> uint32 node words),
        byte-identical to the JAX package.  ``spec`` selects/orders stages
        declaratively (a :class:`CompressionSpec`, its dict, or its JSON);
        ``budget_bytes`` instead walks the budget ladder and keeps the
        first plan whose encoded stream fits; ``max_pred_delta`` (budget
        search only) also rejects rungs whose probe-set prediction drift
        exceeds it.  The :class:`CompressionReport` lands on
        ``self.compression_report``; a lossy plan replaces ``self.forest``
        with the transformed forest, so every backend (reference included)
        runs the deployed model.  Recompression always restarts from the
        exact forest.  Returns self for chaining.
        """
        self._require_fitted()
        if spec is not None and budget_bytes is not None:
            raise ValueError("pass either spec= or budget_bytes=, not both")
        if max_pred_delta is not None and budget_bytes is None:
            raise ValueError(
                "max_pred_delta gates the budget ladder; pass it together "
                "with budget_bytes"
            )
        if isinstance(spec, str):
            spec = CompressionSpec.from_json(spec)
        elif isinstance(spec, dict):
            spec = CompressionSpec.from_dict(spec)
        base = self.forest if self._forest_exact is None else self._forest_exact
        if budget_bytes is not None:
            res = search_budget(
                base, budget_bytes, probe=probe, max_pred_delta=max_pred_delta
            )
        else:
            res = run_pipeline(base, spec, probe=probe)
        if res.packed is None:
            raise ValueError(
                "spec must include the 'encode' and 'pack' stages to produce "
                f"a deployable artifact (got stages={res.report.spec.stages})"
            )
        self._forest_exact = base
        self.forest = res.forest
        self.encoded, self.decoded, self.packed = res.encoded, res.decoded, res.packed
        self.spec = res.report.spec
        self.compression_report = res.report
        self._device_packed = None
        self._predict_fns.clear()
        return self

    @property
    def forest_exact(self) -> Forest | None:
        """The untransformed trained forest (before any lossy stage)."""
        return self._forest_exact if self._forest_exact is not None else self.forest

    def device_packed(self):
        """The packed arrays on the model's device, copied there once."""
        from repro_torch.kernels.ops import to_device

        if not self.is_compressed:
            self.compress()
        if self._device_packed is None:
            self._device_packed = to_device(self.packed, self.device)
        return self._device_packed

    # ------------------------------------------------------------ prediction
    def predictor(self, backend: str | PredictorBackend | None = None):
        """The ``(n, d) -> (n, C)`` function for a backend (a tensor on the
        model's device).  Packed backends compress on first use."""
        self._require_fitted()
        if isinstance(backend, PredictorBackend):
            b = backend
        else:
            b = resolve_backend(backend, compressed=self.is_compressed,
                                device=self.device)
        if b.requires_compressed and not self.is_compressed:
            self.compress()
        fn = self._predict_fns.get(b.name)
        if fn is None:
            fn = b.build(self)
            self._predict_fns[b.name] = fn
        return fn

    def predict(self, X, backend: str | None = None) -> np.ndarray:
        """(n, d) raw floats -> (n, C) raw ensemble scores (margins)."""
        x = torch.as_tensor(np.asarray(X, dtype=np.float32), device=self.device)
        return self.predictor(backend)(x).cpu().numpy()

    def predict_proba(self, X, backend: str | None = None) -> np.ndarray:
        """(n, d) -> (n, n_classes) probabilities (classification tasks)."""
        scores = self.predict(X, backend=backend)
        if self.config.task == "binary":
            p = 1.0 / (1.0 + np.exp(-scores[:, 0]))
            return np.stack([1.0 - p, p], axis=1)
        if self.config.task == "multiclass":
            z = scores - scores.max(axis=1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=1, keepdims=True)
        raise ValueError("predict_proba is undefined for regression")

    def predict_label(self, X, backend: str | None = None) -> np.ndarray:
        """(n, d) -> (n,) predicted value / class id."""
        scores = self.predict(X, backend=backend)
        if self.config.task == "binary":
            return (scores[:, 0] > 0).astype(np.int32)
        if self.config.task == "multiclass":
            return np.argmax(scores, axis=1).astype(np.int32)
        return scores[:, 0]

    def score(self, X, y, backend: str | None = None) -> float:
        """Task metric (R² / accuracy) on raw features."""
        scores = torch.from_numpy(self.predict(X, backend=backend))
        y = torch.from_numpy(np.asarray(y, np.float32))
        return float(self._loss.metric(y, scores))

    # -------------------------------------------------------------- analysis
    def memory_report(self) -> dict:
        """All layout sizes + reuse factor + the encoded stream length
        (``encoded_stream_basis`` says whether it was encoded or estimated)."""
        self._require_fitted()
        report = compression_summary(self.forest)
        report["reuse_factor"] = reuse_factor(self.forest)
        if self.encoded is not None:
            report["encoded_stream_bytes"] = self.encoded.n_bytes
            report["encoded_stream_bits"] = self.encoded.n_bits
            report["encoded_stream_basis"] = "encoded"
        else:
            # compression_summary already ran the encoder for toad_bytes
            report["encoded_stream_bytes"] = report["toad_bytes"]
            report["encoded_stream_bits"] = int(round(report["toad_bytes"] * 8))
            report["encoded_stream_basis"] = "estimated"
        if self.compression_report is not None:
            report["compression_spec"] = self.compression_report.spec.name
            report["max_abs_pred_delta"] = self.compression_report.max_abs_pred_delta
        if self.aux is not None and "toad_bytes" in self.aux:
            report["trainer_accounted_bytes"] = float(self.aux["toad_bytes"])
        return report

    # ------------------------------------------------------------ persistence
    def verify(self) -> list:
        """Structurally verify the fitted model (``analysis.verify``): the
        list of :class:`~repro_torch.analysis.Diagnostic` findings, empty
        for a well-formed model.  ``save()`` runs the same checks and
        refuses on any error-severity finding."""
        from repro_torch.analysis.verify import verify_model

        self._require_fitted()
        return verify_model(self)

    def save(self, path: str, verify: bool = True) -> str:
        """Persist as a versioned .toad artifact (see ``api.artifact``);
        with ``verify=True`` toadcheck runs on the bundle first and the
        save refuses on any error-severity finding."""
        from repro_torch.api.artifact import save_artifact

        return save_artifact(self, path, verify=verify)

    @classmethod
    def load(cls, path: str, verify: bool = True, device="cuda") -> "ToadModel":
        """Load a .toad artifact (or a legacy pre-versioning .npz bundle)
        through :func:`repro_torch.api.artifact.load_checked` (toadcheck,
        then the load and its fingerprint probe)."""
        from repro_torch.api.artifact import load_checked

        return load_checked(path, verify=verify, device=device).model

    def __repr__(self) -> str:
        state = (
            "unfitted"
            if not self.is_fitted
            else f"trees={int(self.forest.n_trees)}"
            + (
                f", compressed[{self.spec.name if self.spec else '?'}]"
                if self.is_compressed
                else ""
            )
        )
        return f"ToadModel(task={self.config.task!r}, {state}, device={self.device})"
