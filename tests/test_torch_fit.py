"""The port's estimator API and CLIs for training, on the CPU, against the
JAX package: ``ToadModel.fit`` / ``fit_binned`` / ``score``, the README
quickstart, a port-trained ``.toad`` read by the JAX package, the training
CLI, and the copied data and configuration modules."""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ToadModel as JaxToadModel
from repro.configs import get_gbdt_config as jax_gbdt_config
from repro.data.pipeline import split_dataset as jax_split
from repro.data.synth import REGISTRY as JAX_REGISTRY
from repro.data.synth import load as jax_load
from repro.gbdt import apply_bins as jax_apply_bins

from repro_torch.api import ToadModel
from repro_torch.configs import get_gbdt_config, is_gbdt_arch
from repro_torch.data.pipeline import split_dataset
from repro_torch.data.synth import load
from repro_torch.launch import train as train_cli

ROOT = Path(__file__).resolve().parents[1]
STRUCTURE = ("feature", "thr_bin", "is_split", "leaf_ref", "n_trees", "n_leaf_values")
# the README quickstart's configuration
QUICKSTART = dict(task="binary", n_bins=32, n_rounds=12, max_depth=3,
                  toad_penalty_feature=1.0, toad_penalty_threshold=0.5)


def _data(seed=0, n=600):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def fitted():
    X, y = _data()
    jax_model = JaxToadModel(**QUICKSTART).fit(X, y)
    port = ToadModel(device="cpu", **QUICKSTART).fit(X, y)
    return X, y, jax_model, port


def _same_forest(port_forest, jax_forest):
    for k in STRUCTURE:
        np.testing.assert_array_equal(getattr(port_forest, k).numpy(),
                                      np.asarray(getattr(jax_forest, k)), err_msg=k)
    np.testing.assert_allclose(port_forest.leaf_values.numpy(),
                               np.asarray(jax_forest.leaf_values), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port_forest.edges.numpy(), np.asarray(jax_forest.edges))


def test_fit_and_score_match_jax(fitted):
    X, y, jax_model, port = fitted
    _same_forest(port.forest, jax_model.forest)
    assert set(port.history) == set(jax_model.history)
    for k in jax_model.history:
        np.testing.assert_array_equal(port.history[k].numpy(),
                                      np.asarray(jax_model.history[k]), err_msg=k)
    np.testing.assert_allclose(port.predict(X), jax_model.predict(X), rtol=1e-5, atol=1e-5)
    assert port.score(X, y) == pytest.approx(jax_model.score(X, y), abs=1e-6)
    assert port.score(X, y) > 0.9


def test_fit_binned_matches_jax(fitted):
    X, y, jax_model, _ = fitted
    edges = np.asarray(jax_model.forest.edges)
    bins = np.asarray(jax_apply_bins(jnp.asarray(X), jnp.asarray(edges)))
    jax_b = JaxToadModel(**QUICKSTART).fit_binned(bins, y, edges)
    port_b = ToadModel(device="cpu", **QUICKSTART).fit_binned(bins, y, edges)
    _same_forest(port_b.forest, jax_b.forest)
    _same_forest(port_b.forest, jax_model.forest)


def test_memory_report_carries_the_trainer_bytes(fitted):
    X, y, jax_model, port = fitted
    report = port.memory_report()
    want = jax_model.memory_report()
    assert report["trainer_accounted_bytes"] == want["trainer_accounted_bytes"]
    # the closed form the trainer evaluates equals the encoder's stream
    assert report["trainer_accounted_bytes"] == report["toad_bytes"]
    for k in ("toad_bytes", "pointer_f32_bytes", "n_trees", "n_split_nodes"):
        assert report[k] == want[k], k


def test_refit_drops_compressed_artifacts(fitted):
    X, y, *_ = fitted
    model = ToadModel(device="cpu", **QUICKSTART).fit(X, y).compress()
    model.predict(X[:4], backend="packed")
    assert model.is_compressed and model._predict_fns
    model.fit(X[:300], y[:300])
    assert not model.is_compressed and not model._predict_fns
    assert model.encoded is None and model.spec is None


def test_readme_quickstart_runs_against_the_port():
    readme = (ROOT / "README.md").read_text()
    block = re.search(r"## Quickstart.*?```python\n(.*?)```", readme, re.S).group(1)
    assert "from repro.api import ToadModel" in block
    code = block.replace("from repro.api import ToadModel",
                         "from repro_torch.api import ToadModel")
    code = code.replace("ToadModel(", 'ToadModel(device="cpu", ', 1)
    scope = {}
    exec(compile(code, "README quickstart", "exec"), scope)
    assert scope["model"].device == torch.device("cpu")
    assert scope["acc"] > 0.9 and scope["scores"].shape == (600, 1)


def test_port_trained_artifact_loads_in_the_jax_package(fitted, tmp_path):
    X, y, jax_model, port = fitted
    path = port.compress().save(str(tmp_path / "port.toad"))
    restored = JaxToadModel.load(path)
    np.testing.assert_allclose(restored.predict(X), port.predict(X), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(restored.predict(X), jax_model.predict(X),
                               rtol=1e-5, atol=1e-5)
    assert restored.config == dataclasses.replace(jax_model.config)
    back = ToadModel.load(path, device="cpu")
    np.testing.assert_array_equal(back.predict(X), port.predict(X))


def test_train_cli_on_the_cpu(capsys):
    out = train_cli.main(["--arch", "toad_gbdt", "--dataset", "kr_vs_kp", "--steps", "16",
                          "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "dataset=kr_vs_kp device=cpu" in printed and "ReF=" in printed
    assert out["metric"] > 0.8 and out["n_trees"] >= 1
    assert out["trainer_bytes"] == out["toad_bytes"]
    with pytest.raises(SystemExit):  # the LM path is tests/test_torch_train_loop.py's
        train_cli.main(["--arch", "no-such-arch", "--device", "cpu"])
    assert "'no-such-arch': not toad_gbdt nor one of" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_synthetic_datasets_equal_jax(name):
    ds, jds = load(name, seed=3, n=400), jax_load(name, seed=3, n=400)
    assert (ds.name, ds.task, ds.n_classes) == (jds.name, jds.task, jds.n_classes)
    np.testing.assert_array_equal(ds.x, jds.x)
    np.testing.assert_array_equal(ds.y, jds.y)
    sp, jsp = split_dataset(ds, seed=1, n_bins=32), jax_split(jds, seed=1, n_bins=32)
    for k in ("x_train", "y_train", "x_test", "y_test", "edges"):
        np.testing.assert_array_equal(getattr(sp, k), getattr(jsp, k))


@pytest.mark.parametrize("reduced", [False, True])
def test_gbdt_workload_equals_jax(reduced):
    for name in ("toad_gbdt", "toad-gbdt"):
        assert is_gbdt_arch(name)
        wl, jwl = get_gbdt_config(name, reduced), jax_gbdt_config(name, reduced)
        assert (wl.rows, wl.n_features, wl.n_bins) == (jwl.rows, jwl.n_features, jwl.n_bins)
        assert dataclasses.asdict(wl.gbdt) == dataclasses.asdict(jwl.gbdt)
    assert not is_gbdt_arch("qwen3-4b")
