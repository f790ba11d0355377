"""The port's compression pipeline against the JAX package's, on the CPU.

``core.codebook.quantize`` equals ``repro.core.codebook.quantize`` to the
bit (codebook and indices) over a seeded sweep.  On the
``tests/test_pipeline.py`` and ``tests/test_thr_codebook.py`` fixtures
(forests trained by the JAX package), every ``default_ladder()`` rung and
the threshold codebook in both scopes give the same encoded bytes, the
same transformed forest and the same report sizes as JAX's
``run_pipeline``; prediction drifts agree within 1e-5 (both run
``predict_raw``).  ``search_budget`` picks JAX's rung with JAX's ladder
trace, with and without ``max_pred_delta``, and the same inputs raise the
same ``ValueError``s.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ToadModel as JaxToadModel
from repro.api.model import _FOREST_FIELDS
from repro.core import codebook as jcodebook
from repro.core import pipeline as jpipe
from repro.gbdt import forest as jforest

from repro_torch.api import ToadModel
from repro_torch.core import codebook, pipeline

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import rejecting_budget  # noqa: E402
from repro_torch.gbdt import GBDTConfig, forest_from_numpy

FIT = dict(learning_rate=0.3, toad_penalty_feature=1.0, toad_penalty_threshold=0.5,
           max_depth=3)
DELTA_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _jax_predict_compiled_once():
    """JAX's ``run_pipeline`` measures drift with eager ``predict_raw``,
    whose scan compiles anew on every call (~0.4 s on the CPU).  The same
    function under ``jax.jit`` compiles once a shape, so the module runs
    JAX's pipeline with it; the encoded bytes do not depend on it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jforest, "predict_raw", jax.jit(jforest.predict_raw))
        yield


def _data(seed, task):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    if task == "binary":
        y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    else:
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def models():
    """name -> JAX model fitted on the JAX package's pipeline fixtures:
    ``pipeline`` as ``tests/test_pipeline.py``'s budget tests fit it (16
    bins, 16 rounds), ``thr`` as ``tests/test_thr_codebook.py`` (32 bins,
    10 rounds), ``multiclass`` a 3-class fit of the latter's shape."""
    out = {}
    X, y = _data(0, "binary")
    out["pipeline"] = JaxToadModel(task="binary", n_bins=16, n_rounds=16, **FIT).fit(X, y)
    out["thr"] = JaxToadModel(task="binary", n_bins=32, n_rounds=10, **FIT).fit(X, y)
    X, y = _data(1, "multiclass")
    out["multiclass"] = JaxToadModel(task="multiclass", n_classes=3, n_bins=32,
                                     n_rounds=10, **FIT).fit(X, y)
    return out


def _port_forest(jforest):
    arrays = {f: np.asarray(getattr(jforest, f)) for f in _FOREST_FIELDS}
    return forest_from_numpy(arrays, jforest.n_ensembles, device="cpu")


def _port_model(jm):
    cfg = GBDTConfig(**dataclasses.asdict(jm.config))
    return ToadModel.from_forest(_port_forest(jm.forest), config=cfg,
                                 n_bins=jm.n_bins, device="cpu")


def _port_spec(jspec):
    return pipeline.CompressionSpec.from_dict(jspec.to_dict())


def _assert_same_result(res, jres):
    """Same stream, forest, serving arrays and report sizes; drifts close."""
    assert res.encoded.n_bits == jres.encoded.n_bits
    assert res.encoded.thr_codebook_bits == jres.encoded.thr_codebook_bits
    np.testing.assert_array_equal(res.encoded.data, jres.encoded.data)
    for f in _FOREST_FIELDS:
        np.testing.assert_array_equal(getattr(res.forest, f).numpy(),
                                      np.asarray(getattr(jres.forest, f)), err_msg=f)
    for f in ("words", "leaf_ref", "leaf_values", "thr_table", "thr_offsets",
              "used_features", "base_score"):
        np.testing.assert_array_equal(getattr(res.packed, f),
                                      np.asarray(getattr(jres.packed, f)), err_msg=f)
    rep, jrep = res.report, jres.report
    assert rep.spec.to_dict() == jrep.spec.to_dict()
    for key in ("bytes_initial", "n_bytes", "packed_bytes", "budget_bytes", "fits",
                "max_pred_delta"):
        assert getattr(rep, key) == getattr(jrep, key), key
    assert rep.ratio == jrep.ratio
    assert [s.stage for s in rep.stages] == [s.stage for s in jrep.stages]
    for s, js in zip(rep.stages, jrep.stages):
        assert (s.bytes_before, s.bytes_after, s.info) == \
            (js.bytes_before, js.bytes_after, js.info), s.stage
        assert s.max_abs_pred_delta == pytest.approx(js.max_abs_pred_delta, abs=DELTA_ATOL)
    assert rep.max_abs_pred_delta == pytest.approx(jrep.max_abs_pred_delta, abs=DELTA_ATOL)
    assert len(rep.ladder) == len(jrep.ladder)
    for r, jr in zip(rep.ladder, jrep.ladder):
        assert {k: r[k] for k in ("spec", "n_bytes", "fits", "accuracy_ok")} == \
            {k: jr[k] for k in ("spec", "n_bytes", "fits", "accuracy_ok")}
        assert r["max_abs_pred_delta"] == pytest.approx(jr["max_abs_pred_delta"],
                                                        abs=DELTA_ATOL)


# ------------------------------------------------------------------ codebook
QUANTIZE_CASES = [  # (n, bits, kind, seed)
    (17, 2, "normal", 0), (300, 3, "heavy", 1), (1000, 4, "rounded", 2),
    (2500, 6, "uniform", 3), (777, 5, "normal", 4), (4096, 4, "heavy", 5),
    (600, 9, "normal", 6), (5000, 6, "rounded", 7),
]


@pytest.mark.parametrize("n,bits,kind,seed", QUANTIZE_CASES)
def test_quantize_matches_jax_to_the_bit(n, bits, kind, seed):
    rng = np.random.default_rng(seed)
    w = {"normal": lambda: rng.normal(size=n),
         "heavy": lambda: 0.1 * rng.standard_t(2, size=n),
         "rounded": lambda: np.round(rng.normal(size=n), 2),
         "uniform": lambda: rng.uniform(-3.0, 3.0, size=n)}[kind]().astype(np.float32)
    jcb, jidx = jcodebook.quantize(jnp.asarray(w), bits=bits, iters=8)
    cb, idx = codebook.quantize(torch.from_numpy(w), bits=bits, iters=8)
    assert cb.device.type == idx.device.type == "cpu"
    assert idx.dtype == (torch.uint8 if bits <= 8 else torch.uint16)
    np.testing.assert_array_equal(cb.numpy().view(np.uint32),
                                  np.asarray(jcb).view(np.uint32))
    np.testing.assert_array_equal(idx.numpy().astype(np.int64),
                                  np.asarray(jidx).astype(np.int64))
    back = codebook.dequantize(cb, idx, dtype=torch.float32).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jcodebook.dequantize(jcb, jidx, dtype=jnp.float32)))
    assert codebook.quantized_bytes((n,), bits) == jcodebook.quantized_bytes((n,), bits)


# ------------------------------------------------------------------ pipeline
LADDER = [s.name for s in jpipe.default_ladder()]


@pytest.fixture(scope="module")
def jax_ladder(models):
    """rung name -> JAX's ``run_pipeline`` result on the ``pipeline``
    fixture, over its probe (each JAX run retraces ``predict_raw``: made
    once a module)."""
    jm = models["pipeline"]
    probe = jpipe.probe_inputs(jm.forest)
    return {s.name: jpipe.run_pipeline(jm.forest, s, probe=probe)
            for s in jpipe.default_ladder()}


def test_ladder_and_spec_builders_match_jax():
    assert [s.to_dict() for s in pipeline.default_ladder()] == \
        [s.to_dict() for s in jpipe.default_ladder()]
    for name in ("exact", "fp16_leaves", "codebook", "thr_codebook", "codebook_full"):
        assert getattr(pipeline.CompressionSpec, name)().to_dict() == \
            getattr(jpipe.CompressionSpec, name)().to_dict(), name
    assert pipeline.list_stages() == jpipe.list_stages()


@pytest.mark.parametrize("rung", LADDER)
def test_ladder_rung_matches_jax(models, jax_ladder, rung):
    jm = models["pipeline"]
    probe = jpipe.probe_inputs(jm.forest)
    forest = _port_forest(jm.forest)
    np.testing.assert_array_equal(pipeline.probe_inputs(forest), probe)
    jres = jax_ladder[rung]
    _assert_same_result(
        pipeline.run_pipeline(forest, _port_spec(jres.report.spec), probe=probe), jres)


@pytest.mark.parametrize("rung", ["fp16-leaves", "codebook-t5l4"])
def test_multiclass_rung_matches_jax(models, rung):
    jm = models["multiclass"]
    jspec = next(s for s in jpipe.default_ladder() if s.name == rung)
    _assert_same_result(pipeline.run_pipeline(_port_forest(jm.forest), _port_spec(jspec)),
                        jpipe.run_pipeline(jm.forest, jspec))


@pytest.mark.parametrize("scope,bits", [("global", 3), ("per_feature", 2)])
def test_threshold_codebook_matches_jax(models, scope, bits):
    jm = models["thr"]
    jspec = jpipe.CompressionSpec.thr_codebook(bits, scope=scope)
    _assert_same_result(pipeline.run_pipeline(_port_forest(jm.forest), _port_spec(jspec)),
                        jpipe.run_pipeline(jm.forest, jspec))


def test_threshold_and_leaf_codebooks_together_match_jax(models):
    jm = models["thr"]
    jspec = jpipe.CompressionSpec.codebook_full(3, 3, scope="per_feature")
    _assert_same_result(pipeline.run_pipeline(_port_forest(jm.forest), _port_spec(jspec)),
                        jpipe.run_pipeline(jm.forest, jspec))


@pytest.mark.parametrize("floor", [None, "rejecting"])
def test_search_budget_picks_jaxs_rung(models, jax_ladder, floor):
    """The same rung and the same ladder trace.  Without a floor the
    budget is 0.7 of the exact stream (``tests/test_pipeline.py``'s); with
    one, a budget and floor under which a rung that fits is rejected on
    accuracy and a later one accepted."""
    jm = models["pipeline"]
    if floor is None:
        budget, max_pred_delta, rejected = jpipe.encode(jm.forest).n_bytes * 0.7, None, None
    else:
        pick = rejecting_budget([(name, jax_ladder[name].report.n_bytes,
                                  jax_ladder[name].report.max_abs_pred_delta)
                                 for name in LADDER])
        assert pick is not None, "the fixture needs a fitting rung rejected on accuracy"
        budget, max_pred_delta, rejected = pick
    jres = jpipe.search_budget(jm.forest, budget, max_pred_delta=max_pred_delta)
    res = pipeline.search_budget(_port_forest(jm.forest), budget,
                                 max_pred_delta=max_pred_delta)
    _assert_same_result(res, jres)
    assert res.report.summary() == jres.report.summary()
    if rejected is not None:
        rung = next(r for r in res.report.ladder if r["spec"] == rejected)
        assert rung["fits"] and not rung["accuracy_ok"]
        assert res.report.spec.name != rejected and "(over floor)" in res.report.summary()


def test_compress_facade_matches_jax_and_restarts_from_the_exact_forest(models):
    jm = JaxToadModel.from_forest(models["pipeline"].forest, config=models["pipeline"].config,
                                  n_bins=16)
    model = _port_model(models["pipeline"])
    spec = jpipe.CompressionSpec.codebook(3)
    jm.compress(spec=spec)
    model.compress(spec=spec.to_json())
    np.testing.assert_array_equal(model.encoded.data, jm.encoded.data)
    assert model.spec.to_dict() == jm.spec.to_dict()
    assert model.compression_report.n_bytes == jm.compression_report.n_bytes
    X, _ = _data(0, "binary")
    # a lossy plan replaces the forest: every backend runs the deployed model
    np.testing.assert_allclose(model.predict(X, backend="reference"), jm.predict(X),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.predict(X, backend="packed"),
                               model.predict(X, backend="reference"), rtol=1e-5, atol=1e-5)
    assert model.memory_report()["compression_spec"] == \
        jm.memory_report()["compression_spec"]
    # the budget path is the search's result; recompression restarts from
    # the exact forest
    budget = jpipe.encode(jm.forest).n_bytes * 0.7
    model.compress(budget_bytes=budget)
    want = pipeline.search_budget(model.forest_exact, budget)
    np.testing.assert_array_equal(model.encoded.data, want.encoded.data)
    assert model.compression_report.fits and model.compression_report.ladder
    jm.compress()
    model.compress()
    np.testing.assert_array_equal(model.encoded.data, jm.encoded.data)
    assert model.forest_exact is model.forest


def _raises(fn):
    with pytest.raises((ValueError, KeyError)) as err:
        fn()
    return type(err.value), str(err.value)


def _short_ladder(S):
    return (S.exact(), S.fp16_leaves(), S.codebook(2))


ERRORS = {  # (model, CompressionSpec, search_budget) -> raises
    "spec and budget": lambda m, S, sb: m.compress(spec=S.exact(), budget_bytes=100),
    "floor without budget": lambda m, S, sb: m.compress(max_pred_delta=0.1),
    "no pack stage": lambda m, S, sb: m.compress(
        spec=S(stages=("threshold_width", "encode"))),
    "unknown scope": lambda m, S, sb: m.compress(spec=S.thr_codebook(6, scope="row")),
    "codebook bits": lambda m, S, sb: m.compress(spec=S.thr_codebook(1)),
    "unknown stage": lambda m, S, sb: m.compress(
        spec=S(stages=("leaf_f17", "encode", "pack"))),
    "threshold precision": lambda m, S, sb: m.compress(spec=S(threshold_precision="f8")),
    "impossible budget": lambda m, S, sb: sb(m.forest, 8, ladder=_short_ladder(S)),
    "floor 0 under a lossy budget": lambda m, S, sb: sb(
        m.forest, 400, ladder=_short_ladder(S), max_pred_delta=0.0),
    "encodeless rung": lambda m, S, sb: sb(m.forest, 1e9, ladder=(
        S(stages=("threshold_width", "leaf_f16"), name="no-enc"),)),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_the_same_errors_as_jax(models, case):
    jm = JaxToadModel.from_forest(models["pipeline"].forest, config=models["pipeline"].config,
                                  n_bins=16)
    model = _port_model(models["pipeline"])
    want = _raises(lambda: ERRORS[case](jm, jpipe.CompressionSpec, jpipe.search_budget))
    got = _raises(lambda: ERRORS[case](model, pipeline.CompressionSpec,
                                       pipeline.search_budget))
    assert got == want
    assert not model.is_compressed  # a failed compress keeps the model as it was
