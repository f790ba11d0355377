"""The port's prediction paths against the JAX package's, on the CPU.

``packed_predict`` on CPU tensors (the kernel's plain version) against JAX
``predict_packed_model`` (the Pallas kernel in interpret mode) and
``packed_predict_ref``; the dense ``predict_raw``; ``apply_bins``; the
wrapper's input checks; the forest's numpy round trip."""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.layout as jlayout
from repro.api import ToadModel as JaxToadModel
from repro.gbdt import apply_bins as jax_apply_bins
from repro.gbdt import fit_bins as jax_fit_bins
from repro.gbdt import predict_raw as jax_predict_raw
from repro.gbdt.forest import Forest as JaxForest
from repro.kernels.ops import predict_packed_model as jax_predict_packed_model
from repro.kernels.ref import packed_predict_ref as jax_packed_predict_ref

from repro_torch.core.layout import decode, encode, to_packed
from repro_torch.gbdt import (
    FOREST_FIELDS,
    apply_bins,
    empty_forest,
    fit_bins,
    forest_from_numpy,
    forest_to_numpy,
    predict_binned,
    predict_raw,
)
from repro_torch.kernels.ops import predict_packed_model, to_device
from repro_torch.kernels.predict import packed_predict
from repro_torch.kernels.ref import packed_predict_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import synthetic_forest  # noqa: E402

# the JAX trainer's configurations (shared with the other test_torch_* files)
PENALISED = dict(task="binary", n_rounds=12, max_depth=3, learning_rate=0.3,
                 toad_penalty_feature=1.0, toad_penalty_threshold=0.5)
MULTICLASS = dict(PENALISED, task="multiclass", n_classes=3, n_rounds=6)


def _fit(cfg, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    if cfg["task"] == "binary":
        y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    else:
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    return JaxToadModel(n_bins=16, **cfg).fit(X, y).forest


def _jax_forest(arrays, n_ensembles=1):
    return JaxForest(**{f: jnp.asarray(arrays[f]) for f in FOREST_FIELDS},
                     n_ensembles=n_ensembles)


def _numpy(forest):
    return {f: np.asarray(getattr(forest, f)) for f in FOREST_FIELDS}


def _truncate(forest, n_trees):
    return dataclasses.replace(forest, n_trees=jnp.asarray(n_trees, jnp.int32))


@pytest.fixture(scope="module")
def forests():
    binary = _fit(PENALISED, 0)
    assert int(binary.n_trees) == 12
    return {
        # the tree-block boundaries of tests/test_kernels.py: T < 8, = 8, % 8 != 0
        "T2": _truncate(binary, 2),
        "T8": _truncate(binary, 8),
        "T11": _truncate(binary, 11),
        "multiclass3x6": _fit(MULTICLASS, 1),
        "zero-split": _jax_forest(synthetic_forest(
            2, n_trees=5, max_depth=3, n_features=6, n_bins=16, n_used_features=0)),
        "zero-tree": _jax_forest(synthetic_forest(
            3, n_trees=0, max_depth=3, n_features=6, n_bins=16, n_used_features=4)),
        "synthetic": _jax_forest(synthetic_forest(
            4, n_trees=30, max_depth=5, n_features=10, n_bins=32,
            n_used_features=7, max_thr_per_feature=5, n_leaf_values=40)),
    }


CASES = ["T2", "T8", "T11", "multiclass3x6", "zero-split", "zero-tree", "synthetic"]


def _rows(d, n, seed, nan_frac=0.05):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.normal(size=(n, d))).astype(np.float32)
    x[rng.random(x.shape) < nan_frac] = np.nan
    return x


@pytest.mark.parametrize("case", CASES)
def test_packed_predict_matches_jax(forests, case):
    jf = forests[case]
    n = 300  # two 256-row tiles, the second one ragged
    x = _rows(jf.n_features, n, seed=n)
    port = forest_from_numpy(_numpy(jf), jf.n_ensembles, device="cpu")
    packed = to_packed(decode(encode(port)))
    dev = to_device(packed, "cpu")
    launches = packed_predict.launches
    got = packed_predict(torch.from_numpy(x), *dev.arrays(), **dev.meta())
    assert packed_predict.launches == launches  # the CPU never launches
    assert got.shape == (n, jf.n_ensembles)

    jp = jlayout.to_packed(jlayout.decode(jlayout.encode(jf)))
    pallas = np.asarray(jax_predict_packed_model(jp, x))
    oracle = np.asarray(jax_packed_predict_ref(
        jnp.asarray(x), *(jnp.asarray(getattr(jp, f)) for f in (
            "words", "leaf_ref", "leaf_values", "thr_table", "thr_offsets",
            "used_features", "base_score")),
        max_depth=jp.max_depth, tidx_bits=jp.tidx_bits, n_ensembles=jp.n_ensembles))
    # the Pallas kernel sums 8-tree blocks before adding them: 1e-6
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-6, atol=1e-6)
    # the entry point on host arrays gives the same scores
    np.testing.assert_array_equal(
        predict_packed_model(packed, x, device="cpu").numpy(), got.numpy())
    np.testing.assert_array_equal(
        packed_predict_ref(torch.from_numpy(x), *dev.arrays(), **dev.meta()).numpy(),
        got.numpy())


@pytest.mark.parametrize("case", ["T11", "multiclass3x6", "zero-split", "synthetic"])
def test_predict_raw_matches_jax(forests, case):
    jf = forests[case]
    x = _rows(jf.n_features, 300, seed=7)
    want = np.asarray(jax_predict_raw(jf, jnp.asarray(x)))
    port = forest_from_numpy(_numpy(jf), jf.n_ensembles, device="cpu")
    got = predict_raw(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the dense reference agrees with the packed path
    packed = to_packed(decode(encode(port)))
    np.testing.assert_allclose(got, predict_packed_model(packed, x, device="cpu").numpy(),
                               rtol=1e-5, atol=1e-5)


def test_apply_bins_matches_jax_on_edges_nan_and_inf():
    edges = np.asarray([[0.0, 1.0, np.inf, np.inf],
                        [-2.0, -1.0, 0.5, 3.0],
                        [np.inf, np.inf, np.inf, np.inf]], np.float32)
    x = np.asarray([[np.nan, 1.0, -5.0],
                    [np.inf, -1.0, 0.0],
                    [1.0, 0.5, np.nan],
                    [0.0, 3.0, -np.inf],
                    [0.5, 3.5, 7.0]], np.float32)
    x = np.concatenate([x, np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)])
    want = np.asarray(jax_apply_bins(jnp.asarray(x), jnp.asarray(edges)))
    got = apply_bins(torch.from_numpy(x), torch.from_numpy(edges))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # NaN lands past the last edge; a value on an edge stays left of it
    assert got[0, 0] == 4 and got[2, 0] == 1 and got[1, 1] == 1


def test_fit_bins_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    x[:, 2] = np.round(x[:, 2])  # low cardinality: duplicate quantiles -> +inf
    np.testing.assert_array_equal(fit_bins(x, 16), jax_fit_bins(x, 16))


def _wrapper_args():
    packed = to_packed(decode(encode(forest_from_numpy(
        synthetic_forest(9, n_trees=4, max_depth=3, n_features=6, n_bins=16,
                         n_used_features=3), 1, device="cpu"))))
    dev = to_device(packed, "cpu")
    return torch.zeros((8, 6)), list(dev.arrays()), dev.meta()


@pytest.mark.parametrize("bad", [
    "x-float64", "x-non-contiguous", "x-1d", "words-int64", "leaf_ref-shape",
    "base-shape", "feature-past-x", "feature-past-x-known-max", "negative-feature",
    "wrong-depth",
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, arrays, meta = _wrapper_args()
    if bad == "x-float64":
        x = x.double()
    elif bad == "x-non-contiguous":
        x = torch.zeros((6, 8)).t()
    elif bad == "x-1d":
        x = x[0]
    elif bad == "words-int64":
        arrays[0] = arrays[0].to(torch.int64)
    elif bad == "leaf_ref-shape":
        arrays[1] = arrays[1][:, :-1].contiguous()
    elif bad == "base-shape":
        arrays[6] = torch.zeros(2)
    elif bad == "feature-past-x":
        x = torch.zeros((8, int(arrays[5].max())))
    elif bad == "feature-past-x-known-max":  # the holder's path: no read-back
        meta = dict(meta, max_feature=int(arrays[5].max()))
        x = torch.zeros((8, int(arrays[5].max())))
    elif bad == "negative-feature":
        arrays[5] = arrays[5].clone()
        arrays[5][0] = -1
    elif bad == "wrong-depth":
        meta = dict(meta, max_depth=meta["max_depth"] + 1)
    with pytest.raises(ValueError, match="packed_predict"):
        packed_predict(x, *arrays, **meta)


@pytest.mark.parametrize("case", ["T11", "multiclass3x6", "zero-tree"])
def test_forest_numpy_roundtrip(forests, case):
    arrays = _numpy(forests[case])
    port = forest_from_numpy(arrays, forests[case].n_ensembles, device="cpu")
    back = forest_to_numpy(port)
    assert set(back) == set(FOREST_FIELDS)
    for f in FOREST_FIELDS:
        assert back[f].dtype == arrays[f].dtype, f
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)
    assert port.max_depth == forests[case].max_depth
    assert port.n_bins == forests[case].n_bins


def test_empty_forest_predicts_base_and_binned_matches_raw():
    f = empty_forest(n_features=3, n_edges=4, tree_capacity=2, max_depth=2,
                     leaf_capacity=4, device="cpu")
    f = dataclasses.replace(f, base_score=torch.tensor([0.75]),
                            n_trees=torch.tensor(2, dtype=torch.int32))
    x = torch.from_numpy(_rows(3, 20, seed=3))
    np.testing.assert_array_equal(predict_raw(f, x).numpy(), 0.75)
    bins = apply_bins(x, f.edges)
    np.testing.assert_array_equal(predict_binned(f, bins).numpy(), 0.75)


def test_holder_checks_the_feature_range_once():
    packed = to_packed(decode(encode(forest_from_numpy(
        synthetic_forest(9, n_trees=4, max_depth=3, n_features=6, n_bins=16,
                         n_used_features=3), 1, device="cpu"))))
    dev = to_device(packed, "cpu")
    assert dev.max_feature == int(packed.used_features.max()) < dev.n_features
    x = np.zeros((5, 6), np.float32)
    np.testing.assert_array_equal(
        predict_packed_model(dev, x, device="cpu").numpy(),
        packed_predict(torch.from_numpy(x), *dev.arrays(), **dev.meta()).numpy())
    with pytest.raises(ValueError, match="outside"):
        to_device(dataclasses.replace(packed, n_features=dev.max_feature), "cpu")
