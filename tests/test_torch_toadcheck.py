"""The port's toadcheck against the JAX package's, on the CPU.

The ``tests/test_toadcheck.py`` artifact farm (every spec × binary and
multiclass, plus a legacy v1 bundle, written by the JAX package) verifies
with no error finding in the port, and with the JAX package's findings.
Each corruption fixture of that file (truncated payload, codebook ref,
threshold order, manifest accounting, version stamp, spec/stream mismatch,
forest array defect) and a tampered early-exit table get the same
diagnostics from the port as from ``repro.analysis.verify`` (code,
severity, section, bit offset and message), and the port refuses to load
them.  Lossy bundles cross between the packages both ways.  The CLI
``python -m repro_torch.launch.toadcheck`` exits 0/1/2, and the serve CLI
refuses a corrupted bundle.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.analysis import verify_artifact as jax_verify_artifact
from repro.analysis import verify_stream as jax_verify_stream
from repro.api import CompressionSpec as JaxSpec
from repro.api import EarlyExitPolicy as JaxPolicy
from repro.api import ToadModel as JaxToadModel
from repro.api.artifact import load_checked as jax_load_checked
from repro.api.model import _FOREST_FIELDS
from repro.gbdt import forest as jforest

import repro_torch.core.pipeline as pipeline
from repro_torch.analysis import (
    CATALOG,
    Baseline,
    Diagnostic,
    errors,
    format_diagnostics,
    verify_artifact,
    verify_stream,
)
from repro_torch.api import (
    ArtifactError,
    CompressionSpec,
    ToadModel,
    load_artifact,
    load_checked,
)
from repro_torch.core.layout import EncodedModel, stream_offsets
from repro_torch.gbdt import GBDTConfig, forest_from_numpy
from repro_torch.launch import toadcheck

ROOT = Path(__file__).resolve().parents[1]

SPECS = {
    "exact": "exact",
    "fp16-leaves": "fp16_leaves",
    "codebook-4bit": ("codebook", 4),
    "thr-codebook": "thr_codebook",
    "codebook-full": "codebook_full",
}


@pytest.fixture(scope="module", autouse=True)
def _jax_predict_compiled_once():
    """JAX's ``run_pipeline`` measures drift with eager ``predict_raw``,
    whose scan compiles anew on every call (~0.4 s on the CPU).  The same
    function under ``jax.jit`` compiles once a shape, so the module's JAX
    bundles are compressed with it; the encoded bytes do not depend on it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jforest, "predict_raw", jax.jit(jforest.predict_raw))
        yield


def _spec(S, how):
    name, *args = how if isinstance(how, tuple) else (how,)
    return getattr(S, name)(*args)


def _fit(task, n_classes=0):
    """``tests/test_toadcheck.py``'s fit."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    if task == "binary":
        y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    else:
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    model = JaxToadModel(task=task, n_classes=n_classes, n_bins=16,
                         n_rounds=8, max_depth=3, learning_rate=0.3)
    return model.fit(X, y), X


@pytest.fixture(scope="module")
def farm(tmp_path_factory):
    """(paths: key -> JAX-written bundle, models: task -> (JAX model, X)),
    built once; the keys as in ``tests/test_toadcheck.py``."""
    root = tmp_path_factory.mktemp("toadcheck")
    models = {"binary": _fit("binary"), "multiclass": _fit("multiclass", 3)}
    paths = {}
    for task, (model, _) in models.items():
        for name, how in SPECS.items():
            model.compress(spec=_spec(JaxSpec, how))  # from the exact forest
            paths[f"{task}/{name}"] = model.save(str(root / f"{task}-{name}.toad"))
    model = models["binary"][0]
    model.compress()
    arrays = {f: np.asarray(getattr(model.forest, f)) for f in _FOREST_FIELDS}
    cfg = dataclasses.asdict(model.config)
    cfg.pop("hist_quant_bits")  # the field postdates the legacy format
    meta = {"config": cfg, "n_bins": model.n_bins,
            "n_ensembles": model.forest.n_ensembles, "compressed": True}
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    arrays["toad_stream"] = model.encoded.data
    arrays["toad_stream_bits"] = np.asarray(model.encoded.n_bits, np.int64)
    p = str(root / "legacy-v1.npz")
    np.savez_compressed(p, **arrays)
    paths["binary/legacy-v1"] = p
    model.early_exit_policy = JaxPolicy(epsilon=0.0)
    paths["binary/early-exit"] = model.save(str(root / "binary-ee.toad"))
    model.early_exit_policy = None
    return paths, models


def _read_bundle(path):
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
        arrays = {k: np.array(z[k]) for k in z.files}
    return meta, arrays


def _write_bundle(path, meta, arrays):
    arrays = dict(arrays)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return str(path)


def _stream_of(arrays):
    return EncodedModel(
        data=np.array(arrays["toad_stream"], np.uint8),
        n_bits=int(arrays["toad_stream_bits"]),
        thr_codebook_bits=(int(arrays["toad_stream_cb_bits"])
                           if "toad_stream_cb_bits" in arrays else 0),
    )


def _set_bits(data, pos, width, value):
    """Patch a ``width``-bit MSB-first field at bit ``pos`` of the stream."""
    data = np.array(data, np.uint8)
    for i in range(width):
        bit = (value >> (width - 1 - i)) & 1
        byte, off = (pos + i) // 8, 7 - ((pos + i) % 8)
        if bit:
            data[byte] |= 1 << off
        else:
            data[byte] &= ~(1 << off) & 0xFF
    return data


_FIELDS = ("code", "severity", "hint", "file", "section", "bit_offset", "message",
           "location", "fingerprint")


def _same_findings(got, want):
    """The port's diagnostics equal the JAX package's, field by field."""
    assert [{k: d.as_dict()[k] for k in _FIELDS} for d in got] == \
        [{k: d.as_dict()[k] for k in _FIELDS} for d in want]


# ------------------------------------------------------------- valid matrix
VALID = [f"{task}/{name}" for task in ("binary", "multiclass") for name in SPECS] + \
    ["binary/legacy-v1", "binary/early-exit"]


@pytest.mark.parametrize("key", VALID)
def test_valid_matrix_has_no_error_findings(farm, key):
    path = farm[0][key]
    diags = verify_artifact(path)
    assert not errors(diags), f"{key}: {format_diagnostics(diags)}"
    _same_findings(diags, jax_verify_artifact(path))
    loaded = load_checked(path, device="cpu")
    assert loaded.diagnostics == diags and loaded.warnings == diags


def test_catalog_codes_are_the_jax_packages(farm):
    from repro.analysis.diagnostics import CATALOG as JAX_CATALOG

    from repro.analysis.diagnostics import Diagnostic as JaxDiagnostic

    artifact = {c for c in CATALOG if c[4] in "01"}
    for code in artifact:
        assert JAX_CATALOG[code] == CATALOG[code], code
    assert {c for c in JAX_CATALOG if c[4] in "01"} == artifact
    # the lint's TOAD2xx: the JAX codes and severities, with torch wording
    # (JAX's catalog leaves TOAD207 out; its Diagnostic defaults it to error)
    lint = {c for c in CATALOG if c[4] == "2"}
    assert lint == {c for c in JAX_CATALOG if c[4] == "2"} | {"TOAD207"}
    for code in lint:
        assert CATALOG[code][0] == JaxDiagnostic(code=code, message="").severity, code
    assert artifact | lint == set(CATALOG)


# ------------------------------------------------------- corruption fixtures
def _truncated(paths):
    meta, arrays = _read_bundle(paths["binary/exact"])
    arrays["toad_stream"] = arrays["toad_stream"][:-3]
    return meta, arrays, "TOAD001"


def _codebook_ref(paths):
    meta, arrays = _read_bundle(paths["binary/thr-codebook"])
    enc = _stream_of(arrays)
    so = stream_offsets(enc)
    h = so.header
    assert (1 << h["cb_ref_bits"]) - 1 >= h["n_cb"]
    arrays["toad_stream"] = _set_bits(enc.data, so.sections["thresholds"][0],
                                      h["cb_ref_bits"], (1 << h["cb_ref_bits"]) - 1)
    return meta, arrays, "TOAD007"


def _threshold_order(paths):
    meta, arrays = _read_bundle(paths["binary/exact"])
    enc = _stream_of(arrays)
    so = stream_offsets(enc)
    h = so.header
    pos = so.sections["thresholds"][0]
    for c, w, fl in zip(h["counts"], h["widths"], h["is_float"]):
        if c >= 2:  # bump the first value above its successor
            val = {(16, True): 0x7BFF, (32, True): 0x7F7FFFFF}.get((w, fl), (1 << w) - 1)
            arrays["toad_stream"] = _set_bits(enc.data, pos, w, val)
            return meta, arrays, "TOAD006"
        pos += c * w
    raise AssertionError("no feature with >= 2 thresholds")


def _manifest(paths):
    meta, arrays = _read_bundle(paths["binary/fp16-leaves"])
    meta["manifest"]["sections"]["total_bytes"] += 17.0
    return meta, arrays, "TOAD104"


def _version_stamp(paths):
    meta, arrays = _read_bundle(paths["binary/thr-codebook"])
    meta["format_version"] = 2
    return meta, arrays, "TOAD103"


def _future_version(paths):
    meta, arrays = _read_bundle(paths["binary/thr-codebook"])
    meta["format_version"] = 99
    return meta, arrays, "TOAD102"


def _spec_stream(paths):
    meta, arrays = _read_bundle(paths["binary/thr-codebook"])
    meta["spec"]["thr_codebook_bits"] = 3  # the stream carries 6
    return meta, arrays, "TOAD105"


def _forest_arrays(paths):
    meta, arrays = _read_bundle(paths["binary/exact"])
    e = np.array(arrays["edges"])
    idx = np.where(np.isfinite(e[0]))[0]
    e[0, idx[0]] = e[0, idx[1]] + 1.0
    arrays["edges"] = e
    return meta, arrays, "TOAD107"


def _stream_byte(paths):
    meta, arrays = _read_bundle(paths["multiclass/codebook-full"])
    arrays["toad_stream"][len(arrays["toad_stream"]) // 2] ^= 0x5A
    return meta, arrays, "TOAD106"


def _early_exit_table(paths):
    meta, arrays = _read_bundle(paths["binary/early-exit"])
    meta["early_exit"]["remaining_mass"][0][0] += 0.25
    return meta, arrays, "TOAD120"


def _early_exit_shape(paths):
    meta, arrays = _read_bundle(paths["binary/early-exit"])
    meta["early_exit"]["remaining_mass"] = meta["early_exit"]["remaining_mass"][:-1]
    return meta, arrays, "TOAD121"


CORRUPTIONS = [_truncated, _codebook_ref, _threshold_order, _manifest, _version_stamp,
               _future_version, _spec_stream, _forest_arrays, _stream_byte,
               _early_exit_table, _early_exit_shape]


@pytest.mark.parametrize("corrupt", CORRUPTIONS, ids=lambda f: f.__name__.strip("_"))
def test_corruption_gets_the_jax_packages_findings(farm, tmp_path, corrupt):
    meta, arrays, code = corrupt(farm[0])
    bad = _write_bundle(tmp_path / "bad.toad", meta, arrays)
    diags = verify_artifact(bad)
    assert code in {d.code for d in errors(diags)}
    _same_findings(diags, jax_verify_artifact(bad))
    if "toad_stream" in arrays and code in ("TOAD001", "TOAD006", "TOAD007"):
        enc = _stream_of(arrays)
        _same_findings(verify_stream(enc), jax_verify_stream(enc))
    with pytest.raises(ArtifactError, match=code):
        ToadModel.load(bad, device="cpu")
    # the loader refuses before decoding (a future version before toadcheck)
    with pytest.raises(ArtifactError, match=f"{code}|format version 99"):
        load_artifact(bad, device="cpu")


def test_verify_false_skips_the_structural_check(farm, tmp_path):
    meta, arrays, _ = _manifest(farm[0])
    bad = _write_bundle(tmp_path / "manifest.toad", meta, arrays)
    assert ToadModel.load(bad, verify=False, device="cpu").is_fitted


def test_structural_check_never_predicts(farm, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("structural verification must not predict")

    monkeypatch.setattr(pipeline, "_predict", boom)
    for key in ("binary/exact", "multiclass/thr-codebook", "binary/early-exit"):
        assert verify_artifact(farm[0][key]) == []


# ------------------------------------------------- bundles across the packages
def _port_model(jm):
    arrays = {f: np.asarray(getattr(jm.forest, f)) for f in _FOREST_FIELDS}
    cfg = GBDTConfig(**dataclasses.asdict(jm.config))
    return ToadModel.from_forest(forest_from_numpy(arrays, jm.forest.n_ensembles,
                                                   device="cpu"),
                                 config=cfg, n_bins=jm.n_bins, device="cpu")


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_lossy_bundles_cross_between_the_packages(farm, tmp_path, task):
    paths, models = farm
    jm, X = models[task]
    jm.compress()  # the exact forest again
    port = _port_model(jm).compress(spec=CompressionSpec.codebook_full(3, 3))
    assert port.verify() == []
    path = port.save(str(tmp_path / "port.toad"))
    assert not errors(jax_verify_artifact(path))
    back = JaxToadModel.load(path)  # the JAX package's toadcheck + fingerprint
    np.testing.assert_array_equal(back.encoded.data, port.encoded.data)
    np.testing.assert_allclose(back.predict(X), port.predict(X), rtol=1e-5, atol=1e-5)
    with np.load(path) as z:
        report = json.loads(bytes(z["meta_json"].tobytes()).decode())["report"]
    assert report["spec"]["name"] == "codebook-t3l3" and report["n_bytes"] == \
        port.encoded.n_bytes
    # and the reverse: the JAX package's lossy bundle through the port
    loaded = load_checked(paths[f"{task}/codebook-full"], device="cpu")
    jax_loaded = jax_load_checked(paths[f"{task}/codebook-full"])
    assert loaded.format_version == jax_loaded.format_version == 3
    np.testing.assert_array_equal(loaded.model.encoded.data,
                                  jax_loaded.model.encoded.data)
    np.testing.assert_allclose(loaded.model.predict(X), jax_loaded.model.predict(X),
                               rtol=1e-5, atol=1e-5)


def test_save_refuses_a_malformed_model(farm, tmp_path):
    m = ToadModel.load(farm[0]["binary/exact"], device="cpu")
    m.encoded = EncodedModel(data=m.encoded.data[:-3], n_bits=m.encoded.n_bits)
    assert "TOAD001" in {d.code for d in m.verify()}
    with pytest.raises(ArtifactError, match="TOAD001"):
        m.save(str(tmp_path / "bad.toad"))
    assert not (tmp_path / "bad.toad").exists()


def test_a_streaming_container_waits_for_its_slice(tmp_path):
    """The streaming slice has landed: a ``.toadpack`` goes through
    ``verify_pack``, and a container whose manifest does not parse is
    refused with the JAX package's TOAD110.  (The name dates from when the
    port refused packs with ``NotImplementedError``; it is kept so that the
    test's record stays under one name.)"""
    pack = tmp_path / "m.toadpack"
    pack.write_bytes(b"TOADPACK" + bytes(16))
    diags = verify_artifact(str(pack))
    assert [d.code for d in errors(diags)] == ["TOAD110"]
    _same_findings(diags, jax_verify_artifact(str(pack)))


# ------------------------------------------------------------------ the CLIs
def test_toadcheck_cli_exit_codes(farm, tmp_path, capsys):
    paths, _ = farm
    assert toadcheck.main([paths["multiclass/thr-codebook"]]) == 0
    assert "0 error(s), 0 warning(s)/info" in capsys.readouterr().out
    meta, arrays, _ = _truncated(paths)
    bad = _write_bundle(tmp_path / "trunc.toad", meta, arrays)
    assert toadcheck.main([bad, "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    jax_doc = json.loads(format_diagnostics(jax_verify_artifact(bad), "json"))
    assert doc == jax_doc and "TOAD001" in {d["code"] for d in doc}
    # a warning is reported, never fatal
    meta, arrays = _read_bundle(paths["binary/exact"])
    meta["format_version"] = 3
    warn = _write_bundle(tmp_path / "overclaim.toad", meta, arrays)
    assert toadcheck.main([warn]) == 0
    assert "0 error(s), 1 warning(s)/info" in capsys.readouterr().out
    assert toadcheck.main([str(tmp_path / "nope.toad")]) == 2
    # a directory is linted (TOAD2xx): clean under the port's baseline
    assert toadcheck.main([str(ROOT / "src" / "repro_torch")]) == 0
    assert "0 error(s)" in capsys.readouterr().out
    pack = tmp_path / "m.toadpack"
    pack.write_bytes(b"TOADPACK" + bytes(16))
    assert toadcheck.main([str(pack)]) == 1  # verified: TOAD110, as in JAX
    assert "TOAD110" in capsys.readouterr().out


def test_diagnostics_render_and_baseline_as_in_jax(farm, tmp_path):
    from repro.analysis import Baseline as JaxBaseline

    meta, arrays, _ = _truncated(farm[0])
    bad = _write_bundle(tmp_path / "trunc.toad", meta, arrays)
    diags = verify_artifact(bad)
    assert format_diagnostics(diags) == format_diagnostics(jax_verify_artifact(bad))
    assert format_diagnostics([]) == "no findings"
    with pytest.raises(ValueError, match="text|json"):
        format_diagnostics(diags, "xml")
    base = Baseline({diags[0].fingerprint(): "a truncated fixture"})
    base.save(str(tmp_path / "base.json"))
    assert JaxBaseline.load(str(tmp_path / "base.json")).entries == base.entries
    assert Baseline.load(str(tmp_path / "base.json")).apply(diags) == diags[1:]
    assert Diagnostic(code="TOAD010", message="m").severity == "warning"


def test_serve_cli_refuses_a_corrupted_bundle(farm, tmp_path):
    meta, arrays, _ = _stream_byte(farm[0])
    bad = _write_bundle(tmp_path / "flipped.toad", meta, arrays)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "toad-gbdt",
         "--model", bad, "--smoke", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "refusing to serve" in res.stderr and "TOAD106" in res.stderr
    assert "served" not in res.stdout
