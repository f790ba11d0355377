"""The versioned ``.toad`` deployment artifact (read and write paths).

The same npz container as ``repro.api.artifact``, so a bundle written by
either package loads in the other:

* **format version** — ``TOAD_FORMAT_VERSION``; a loader rejects artifacts
  newer than it understands instead of mis-parsing them, and bundles
  without one (pre-versioning ``.npz``) load as legacy version 1,
* **compression spec**, **encoded stream** (when compressed), the dense
  **forest arrays**, a **manifest** of sizes,
* **eval fingerprint** — a sha256 over the encoded stream bytes plus the
  model's predictions on a deterministic probe set,
* **early exit** (when the model carries an ``EarlyExitPolicy``) — the
  policy and the (T+1, C) ``remaining_mass`` bound table of the bundle's
  tree order, which the JAX package's toadcheck (TOAD120/TOAD121)
  recomputes from the shipped forest.

Both paths run toadcheck (``repro_torch.analysis.verify``): the save path
verifies the bundle after encoding and refuses to write a malformed one;
the load path rejects a newer format version, verifies the bundle
structurally (stream bounds, codebook/threshold invariants, tree topology,
manifest byte accounting, version negotiation, the stream's sha256, the
forest arrays, the early-exit table) *before* a bit is decoded, and checks
the fingerprint probe after.  ``load_checked`` carries toadcheck's
findings (warnings included) in :class:`LoadedArtifact`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from repro_torch.analysis.diagnostics import errors, format_diagnostics
from repro_torch.analysis.verify import verify_artifact, verify_bundle
from repro_torch.core.bitio import StreamBoundsError
from repro_torch.core.layout import EncodedModel, decode, to_packed
from repro_torch.core.memory import compression_summary, stream_sections
from repro_torch.core.pipeline import CompressionSpec, _predict, probe_inputs
from repro_torch.gbdt.forest import FOREST_FIELDS, forest_from_numpy, forest_to_numpy

# 3 added the shared-threshold-codebook stream layout; bundles that don't
# use it are still written as version 2 so older runtimes can load them.
TOAD_FORMAT_VERSION = 3

_FINGERPRINT_N = 32
_FINGERPRINT_SEED = 7
_FINGERPRINT_PRED_ATOL = 2e-4


class ArtifactError(RuntimeError):
    """Raised when a .toad artifact cannot be loaded safely."""


def probe_predictions(
    forest, n: int = _FINGERPRINT_N, seed: int = _FINGERPRINT_SEED
) -> np.ndarray:
    """The model's (n, C) predictions on the deterministic probe set."""
    return _predict(forest, probe_inputs(forest, n=n, seed=seed)).astype(np.float32)


def stream_digest(encoded) -> str:
    """Exact sha256 over the encoded stream bytes + bit length."""
    h = hashlib.sha256(np.asarray(encoded.data, np.uint8).tobytes())
    h.update(int(encoded.n_bits).to_bytes(8, "little"))
    return h.hexdigest()


def build_manifest(model) -> dict:
    """Size + shape summary of a fitted (optionally compressed) model."""
    forest = model.forest
    cb_bits = model.encoded.thr_codebook_bits if model.encoded is not None else 0
    summary = compression_summary(forest)
    manifest = {
        "n_trees": int(forest.n_trees),
        "max_depth": forest.max_depth,
        "n_features": forest.n_features,
        "n_ensembles": forest.n_ensembles,
        "n_leaf_values": int(forest.n_leaf_values),
        "toad_bytes": summary["toad_bytes"],
        "thr_codebook_bits": int(cb_bits),
        "sections": stream_sections(forest, thr_codebook_bits=cb_bits),
    }
    if model.encoded is not None:
        manifest["encoded_stream_bytes"] = model.encoded.n_bytes
        manifest["encoded_stream_bits"] = model.encoded.n_bits
    return manifest


def save_artifact(model, path: str, verify: bool = True) -> str:
    """Persist a fitted model as a versioned .toad bundle at ``path``.

    The path is written verbatim (no extension appended).  With
    ``verify=True`` (default) the bundle is structurally verified after
    encoding (toadcheck) before a byte is written, so an encoder fault
    fails at the producer instead of on a device.
    """
    model._require_fitted()
    arrays = forest_to_numpy(model.forest)
    fingerprint = {
        "n_probe": _FINGERPRINT_N,
        "seed": _FINGERPRINT_SEED,
        "pred_atol": _FINGERPRINT_PRED_ATOL,
    }
    if model.encoded is not None:
        fingerprint["stream_sha256"] = stream_digest(model.encoded)
    arrays["fingerprint_preds"] = probe_predictions(model.forest)
    # stamp the lowest version that can represent this bundle: only the
    # shared-threshold-codebook stream layout needs a version-3 reader
    cb_bits = model.encoded.thr_codebook_bits if model.encoded is not None else 0
    meta = {
        "format_version": 3 if cb_bits > 0 else 2,
        "config": dataclasses.asdict(model.config),
        "n_bins": model.n_bins,
        "n_ensembles": model.forest.n_ensembles,
        "compressed": model.is_compressed,
        "spec": model.spec.to_dict() if model.spec is not None else None,
        "manifest": build_manifest(model),
        "fingerprint": fingerprint,
        "report": (
            model.compression_report.as_dict()
            if model.compression_report is not None
            else None
        ),
    }
    policy = model.early_exit_policy
    if policy is not None:
        from repro_torch.core.treeorder import remaining_mass

        meta["early_exit"] = {
            "policy": policy.to_dict(),
            "remaining_mass": [[float(v) for v in row]
                               for row in remaining_mass(model.forest)],
        }
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    if model.encoded is not None:
        arrays["toad_stream"] = model.encoded.data
        arrays["toad_stream_bits"] = np.asarray(model.encoded.n_bits, np.int64)
        if cb_bits > 0:
            arrays["toad_stream_cb_bits"] = np.asarray(cb_bits, np.int64)
    if verify:
        bad = errors(verify_bundle(meta, arrays, path=path))
        if bad:
            raise ArtifactError(
                f"{path}: refusing to save a structurally invalid bundle:\n"
                + format_diagnostics(bad)
            )
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return path


def save_streaming(model, path: str, verify: bool = True, **kwargs) -> str:
    """Persist a fitted model as a ``.toadpack`` v4 streaming container.

    The block-aligned layout ``repro_torch.stream.format`` documents:
    manifest, then the stream header (feature map + threshold/leaf
    codebooks), then sha256-checksummed tree blocks ordered
    most-informative-first, then the eval fingerprint — so a cold-starting
    server answers after the first block (``repro_torch.stream
    .open_streaming`` / :class:`~repro_torch.stream.progressive
    .ProgressiveScorer`).  The bytes are the JAX package's for the same
    forest and tree order.

    ``kwargs`` pass through to :func:`repro_torch.stream.format.write_pack`
    (``tree_block``, ``tree_order``, ``early_exit``).  With ``verify=True``
    (default) the written container is re-verified (``verify_pack(deep=
    True)``: TOAD11x plus the reassembled stream's TOAD00x walk) before the
    path is returned, as :func:`save_artifact` verifies before it writes.
    """
    from repro_torch.stream.format import write_pack  # lazy: import cycle

    model._require_fitted()
    write_pack(model, path, **kwargs)
    if verify:
        from repro_torch.analysis.verify import verify_pack

        bad = errors(verify_pack(path, deep=True))
        if bad:
            raise ArtifactError(
                f"{path}: refusing to keep a structurally invalid streaming "
                f"container:\n" + format_diagnostics(bad)
            )
    return path


def load_artifact(path: str, verify: bool = True, device="cuda",
                  _structural: bool = True):
    """Load a .toad bundle back into a :class:`ToadModel` on ``device``.

    Rejects artifacts with a newer format version than this runtime
    understands.  With ``verify=True`` (default) the bundle is structurally
    verified (toadcheck, ``verify_bundle``) before anything is decoded, and
    the stored probe-set predictions are then recomputed from the loaded
    forest arrays and compared within the recorded tolerance.
    """
    from repro_torch.api.model import ToadModel
    from repro_torch.gbdt.trainer import GBDTConfig

    with np.load(path) as z:
        if "meta_json" not in z:
            raise ArtifactError(f"{path}: not a .toad artifact (no meta_json)")
        meta = json.loads(bytes(z["meta_json"].tobytes()).decode("utf-8"))
        version = int(meta.get("format_version", 1))
        if version < 1 or version > TOAD_FORMAT_VERSION:
            raise ArtifactError(
                f"{path}: .toad format version {version} is not supported by "
                f"this runtime (max {TOAD_FORMAT_VERSION}); upgrade the runtime "
                f"or re-export the artifact"
            )
        if verify and _structural:
            # a malformed stream or lying manifest is refused before a
            # single bit is decoded
            bad = errors(verify_bundle(meta, {k: z[k] for k in z.files}, path=path))
            if bad:
                raise ArtifactError(
                    f"{path}: structural verification failed "
                    f"({len(bad)} error(s)):\n" + format_diagnostics(bad)
                )
        missing = [f for f in FOREST_FIELDS if f not in z]
        if missing:
            raise ArtifactError(f"{path}: forest arrays missing: {missing}")
        model = ToadModel(
            config=GBDTConfig(**meta["config"]), n_bins=meta["n_bins"], device=device
        )
        model.forest = forest_from_numpy(
            {f: z[f] for f in FOREST_FIELDS}, int(meta["n_ensembles"]), device=device
        )
        fp = (meta.get("fingerprint") or {}) if version >= 2 else {}
        if meta.get("compressed") and "toad_stream" in z:
            encoded = EncodedModel(
                data=np.array(z["toad_stream"], dtype=np.uint8),
                n_bits=int(z["toad_stream_bits"]),
                thr_codebook_bits=(
                    int(z["toad_stream_cb_bits"])
                    if "toad_stream_cb_bits" in z else 0
                ),
            )
            try:
                decoded = decode(encoded)
            except (StreamBoundsError, ValueError, IndexError) as exc:
                raise ArtifactError(f"{path}: corrupted encoded stream: {exc}") from exc
            model.encoded, model.decoded = encoded, decoded
            model.packed = to_packed(decoded)
        if version >= 2:
            if meta.get("spec"):
                model.spec = CompressionSpec.from_dict(meta["spec"])
            model.artifact_meta = meta
            ee = meta.get("early_exit")
            if ee and ee.get("policy"):
                from repro_torch.gbdt.early_exit import EarlyExitPolicy

                model.early_exit_policy = EarlyExitPolicy.from_dict(ee["policy"])
            if verify and fp and "fingerprint_preds" in z:
                current = probe_predictions(
                    model.forest, n=fp["n_probe"], seed=fp["seed"]
                )
                atol = float(fp.get("pred_atol", _FINGERPRINT_PRED_ATOL))
                if not np.allclose(current, z["fingerprint_preds"],
                                   rtol=0.0, atol=atol):
                    raise ArtifactError(
                        f"{path}: eval fingerprint mismatch — the stored arrays "
                        f"do not reproduce the recorded predictions within "
                        f"atol={atol} (corrupted or hand-edited artifact)"
                    )
    return model


@dataclasses.dataclass
class LoadedArtifact:
    """Result of :func:`load_checked`: the model plus its admission record.

    ``diagnostics`` holds toadcheck's full finding list (warnings included;
    errors never reach here, they raise); ``format_version`` is the
    negotiated ``.toad`` format version (1 for legacy pre-versioning
    bundles).
    """

    model: object  # ToadModel
    path: str
    format_version: int
    diagnostics: list

    @property
    def warnings(self) -> list:
        return [d for d in self.diagnostics if d.severity != "error"]


def load_checked(path: str, verify: bool = True, device="cuda") -> LoadedArtifact:
    """The one artifact load-and-verify path for every consumer
    (``ToadModel.load``, ``GBDTEngine``, the serve CLI):

    1. toadcheck (``verify_artifact``): any error-severity finding raises
       :class:`ArtifactError` with the formatted findings before a bit of
       the stream is decoded;
    2. the load itself (decode + the eval-fingerprint probe);
    3. the format version and the warning-level findings, returned beside
       the model.

    ``verify=False`` skips both toadcheck and the fingerprint probe.
    """
    path = str(path)
    diags: list = []
    if verify:
        diags = verify_artifact(path)
        bad = errors(diags)
        if bad:
            raise ArtifactError(
                f"{path}: structural verification failed "
                f"({len(bad)} error(s)):\n" + format_diagnostics(bad)
            )
    # toadcheck already ran: the load still checks the fingerprint probe
    model = load_artifact(path, verify=verify, device=device, _structural=False)
    version = int((model.artifact_meta or {}).get("format_version", 1))
    return LoadedArtifact(model=model, path=path, format_version=version,
                          diagnostics=diags)
