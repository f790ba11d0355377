"""Compression specs and the deterministic probe set.

The port's share of ``repro.core.pipeline`` so far: the declarative,
JSON-serializable :class:`CompressionSpec` (so specs stored in ``.toad``
bundles round-trip), the probe inputs that the artifact's eval fingerprint
is computed on, and the prediction helper the fingerprint uses.  The staged
lossy pipeline (``run_pipeline``, ``search_budget``) is still to port; the
port compresses with the exact spec only.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.gbdt.forest import Forest, predict_raw

DEFAULT_STAGES = ("threshold_width", "encode", "pack")

# Spec fields added after the v2 .toad format shipped.  ``to_dict`` omits
# them at their default values so artifacts that don't use the threshold
# codebook keep a spec dict that v2 runtimes can parse.
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

    @classmethod
    def exact(cls) -> "CompressionSpec":
        """Lossless widths, encode, pack."""
        return cls()

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
