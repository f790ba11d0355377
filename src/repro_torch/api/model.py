"""``ToadModel`` — the estimator facade, on a device.

    model = ToadModel(task="binary", n_bins=32, n_rounds=12, max_depth=3,
                      toad_penalty_feature=1.0, toad_penalty_threshold=0.5)
    model.fit(X, y).compress()                 # trains on the card
    scores = model.predict(X)                  # auto backend: cuda on an H100
    scores = model.predict(X, backend="packed")
    model.save("model.toad");  ToadModel.load("model.toad")

``fit`` bins ``X`` (quantile edges on the host, ``apply_bins`` on the
device) and trains with ``gbdt.trainer.train`` on the model's device;
``history`` and ``aux`` keep the trainer's per-round record and side
outputs.  ``predict`` returns the raw (n, C) ensemble margins;
``predict_proba`` / ``predict_label`` apply the task's link function on
top, ``score`` the task's metric.  The model lives on ``device`` (default
``"cuda"``; ``"cpu"`` only when asked for).

Not here yet: lossy ``compress`` specs and ``budget_bytes`` (they need the
staged compression pipeline); ``compress`` takes the exact spec only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.api.backends import PredictorBackend, resolve_backend
from repro_torch.core.layout import EncodedModel, decode, encode, to_packed
from repro_torch.core.memory import compression_summary, reuse_factor
from repro_torch.core.pipeline import CompressionSpec
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
        self.artifact_meta: dict | None = None
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
        self.spec = self.artifact_meta = None
        self._device_packed = None
        self._predict_fns.clear()

    def compress(self, spec: CompressionSpec | dict | str | None = None,
                 budget_bytes: float | None = None) -> "ToadModel":
        """Encode -> bit stream, decode -> dense arrays, to_packed -> uint32
        node words (the lossless chain, byte-identical to the JAX package).
        Returns self for chaining."""
        self._require_fitted()
        if isinstance(spec, str):
            spec = CompressionSpec.from_json(spec)
        elif isinstance(spec, dict):
            spec = CompressionSpec.from_dict(spec)
        if budget_bytes is not None or (spec is not None and spec != CompressionSpec()):
            raise NotImplementedError(
                "only the exact compression spec is ported so far; lossy specs "
                "and budget_bytes come with the compression pipeline (slice 3)"
            )
        self.encoded = encode(self.forest)
        self.decoded = decode(self.encoded)
        self.packed = to_packed(self.decoded)
        self.spec = CompressionSpec.exact()
        self._device_packed = None
        self._predict_fns.clear()
        return self

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
        if self.spec is not None:
            report["compression_spec"] = self.spec.name
        if self.aux is not None and "toad_bytes" in self.aux:
            report["trainer_accounted_bytes"] = float(self.aux["toad_bytes"])
        return report

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> str:
        """Persist as a versioned .toad artifact (see ``api.artifact``)."""
        from repro_torch.api.artifact import save_artifact

        return save_artifact(self, path)

    @classmethod
    def load(cls, path: str, verify: bool = True, device="cuda") -> "ToadModel":
        """Load a .toad artifact (or a legacy pre-versioning .npz bundle)
        through :func:`repro_torch.api.artifact.load_checked`."""
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
