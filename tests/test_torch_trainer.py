"""The port's losses, in-trainer stream size and trainer against the JAX
package, on the CPU.

``train`` runs on the data of ``tests/test_trainer.py`` beside
``repro.gbdt.train_jit`` for each configuration below: the trees must be the
same (``feature``, ``thr_bin``, ``is_split``, ``leaf_ref``, ``n_trees``,
``n_leaf_values`` equal), the leaf values within ``test_hist_paths_agree``'s
tolerance (rtol 1e-4, atol 1e-5) and the per-round history equal.  Each
JAX configuration compiles once per process (module-scoped cache); ι, ξ
and the budget are runtime arguments, so one compile serves several runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.memory import toad_bits as jax_toad_bits
from repro.gbdt import GBDTConfig as JaxConfig
from repro.gbdt import apply_bins as jax_apply_bins
from repro.gbdt import make_loss as jax_make_loss
from repro.gbdt import train_jit

from repro_torch.core.memory import toad_bits, toad_bits_host
from repro_torch.gbdt import GBDTConfig, apply_bins, fit_bins, make_loss, train, train_grid
from repro_torch.gbdt.trainer import block_cumsum, block_sum

STRUCTURE = ("feature", "thr_bin", "is_split", "leaf_ref", "n_trees", "n_leaf_values")

BINARY = dict(task="binary", n_rounds=16, max_depth=3, learning_rate=0.3)
CONFIGS = {
    # name: (config fields, runtime (ι, ξ, forestsize), data)
    "binary-penalised": (BINARY, (1.0, 0.5, None), "fixture"),
    "binary-budget-400B": (BINARY, (None, None, 400.0), "fixture"),
    "leaf-quant": (dict(BINARY, leaf_quant=0.02), (None, None, None), "fixture"),
    "bf16-min-child-300": (dict(BINARY, hist_dtype="bf16", min_child_samples=300),
                           (None, None, None), "fixture"),
    "multiclass-3": (dict(task="multiclass", n_classes=3, n_rounds=10, max_depth=2,
                          toad_penalty_feature=0.5, toad_penalty_threshold=0.25),
                     (None, None, None), "multiclass"),
    "regression": (dict(task="regression", n_rounds=12, max_depth=3,
                        toad_penalty_feature=2.0, toad_penalty_threshold=0.5),
                   (None, None, None), "regression"),
}


def _data(kind):
    if kind == "multiclass":  # test_multiclass_one_ensemble_per_class's data
        rng = np.random.default_rng(3)
        X = rng.normal(size=(1200, 5)).astype(np.float32)
        y = np.digitize(X[:, 0], [-0.6, 0.6]).astype(np.float32)
        return X, y, fit_bins(X, 16)
    rng = np.random.default_rng(7)  # test_trainer.py's fixture
    X = rng.normal(size=(2500, 8)).astype(np.float32)
    if kind == "regression":
        y = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * X[:, 2] * X[:, 3]).astype(np.float32)
    else:
        y = (1.2 * X[:, 0] - X[:, 1] + 0.4 * X[:, 2] * X[:, 3] > 0).astype(np.float32)
    return X, y, fit_bins(X, 32)


@pytest.fixture(scope="module")
def runs():
    """Per configuration: the data, the JAX results and the port's results
    (computed on first use, shared by the tests of this module)."""
    cache = {}

    def get(name):
        if name not in cache:
            fields, (pf, pt, fs), kind = CONFIGS[name]
            X, y, edges = _data(kind)
            jbins = jax_apply_bins(jnp.asarray(X), jnp.asarray(edges))
            jax_out = train_jit(JaxConfig(**fields), jbins, jnp.asarray(y),
                                jnp.asarray(edges), pf, pt, fs)
            bins = apply_bins(torch.from_numpy(X), torch.from_numpy(edges))
            port_out = train(GBDTConfig(**fields), bins, torch.from_numpy(y),
                             torch.from_numpy(edges), pf, pt, fs)
            cache[name] = (X, y, edges, bins, jax_out, port_out)
        return cache[name]

    return get


def _same_trees(port_forest, jax_forest, label=""):
    for k in STRUCTURE:
        np.testing.assert_array_equal(getattr(port_forest, k).numpy(),
                                      np.asarray(getattr(jax_forest, k)), err_msg=f"{label} {k}")
    np.testing.assert_allclose(port_forest.leaf_values.numpy(),
                               np.asarray(jax_forest.leaf_values),
                               rtol=1e-4, atol=1e-5, err_msg=label)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_grows_the_jax_trees(runs, name):
    *_, (jf, jh, ja), (f, h, a) = runs(name)
    if not all(np.array_equal(getattr(f, k).numpy(), np.asarray(getattr(jf, k)))
               for k in STRUCTURE):
        # a near tie that flipped: show the two gains and their gap
        gap = a["node_gain"].numpy() - np.asarray(ja["node_gain"])
        pytest.fail(f"{name}: trees differ; node gains port/JAX/gap:\n"
                    f"{a['node_gain'].numpy()}\n{np.asarray(ja['node_gain'])}\n{gap}")
    _same_trees(f, jf, name)
    assert set(h) == set(jh)
    for k in jh:
        np.testing.assert_array_equal(h[k].numpy(), np.asarray(jh[k]), err_msg=k)
    np.testing.assert_allclose(a["leaf_cnt"].numpy(), np.asarray(ja["leaf_cnt"]))
    np.testing.assert_array_equal(a["used_feat"].numpy(), np.asarray(ja["used_feat"]))
    np.testing.assert_array_equal(a["used_thr"].numpy(), np.asarray(ja["used_thr"]))
    np.testing.assert_allclose(a["preds"].numpy(), np.asarray(ja["preds"]),
                               rtol=1e-4, atol=1e-5)
    assert float(a["toad_bytes"]) == float(ja["toad_bytes"])


def test_budget_and_quantisation_act(runs):
    *_, (f, h, a) = runs("binary-budget-400B")
    assert float(a["toad_bytes"]) <= 400.0 and int(f.n_trees) >= 1
    assert not bool(h["accepted"].all())  # the budget stopped training
    *_, (fq, hq, _) = runs("leaf-quant")
    assert int(fq.n_leaf_values) < int(hq["n_splits"][-1]) + int(fq.n_trees)
    X, *_, (fb, _, ab) = runs("bf16-min-child-300")
    cnts = ab["leaf_cnt"].numpy()[: int(fb.n_trees)]
    np.testing.assert_array_equal(cnts.sum(axis=1), float(X.shape[0]))
    assert cnts[cnts > 0].min() >= 300


def test_toad_bits_equals_jax_and_the_encoder(runs):
    for name in ("binary-penalised", "multiclass-3", "regression"):
        *_, (jf, _, ja), (f, h, a) = runs(name)
        C = f.n_ensembles
        bits = toad_bits(a["used_feat"], a["used_thr"], f.n_leaf_values, f.n_trees,
                         f.is_split[: int(f.n_trees)].sum(), f.edges, f.max_depth, C)
        jbits = jax_toad_bits(ja["used_feat"], ja["used_thr"], jf.n_leaf_values,
                              jf.n_trees, jnp.sum(jf.is_split[: int(jf.n_trees)]),
                              jf.edges, f.max_depth, C)
        assert int(bits) == int(jbits) == toad_bits_host(f), name


@pytest.mark.parametrize("kind", ["float", "integer", "half"])
def test_toad_bits_width_rules_match_jax(kind):
    """Random used sets over edges that need 32-bit, small-integer and
    f16-exact threshold widths."""
    rng = np.random.default_rng({"float": 0, "integer": 1, "half": 2}[kind])
    d, E = 12, 31
    if kind == "float":
        edges = np.sort(rng.normal(size=(d, E)), axis=1).astype(np.float32)
    elif kind == "integer":
        edges = np.sort(rng.integers(0, 300, (d, E)), axis=1).astype(np.float32)
        edges[::3] *= 300.0  # some features past 65536
    else:
        edges = np.sort(rng.integers(-64, 64, (d, E)) / 8.0, axis=1).astype(np.float32)
    edges[:, -3:] = np.inf
    used_thr = rng.random((d, E)) < 0.2
    used_thr[:, -3:] = False
    used_feat = used_thr.any(axis=1)
    args = (7, 123, 57)  # n_leaf_values, n_trees, n_splits
    for depth, C in ((3, 1), (5, 4)):
        got = toad_bits(torch.from_numpy(used_feat), torch.from_numpy(used_thr),
                        *(torch.tensor(v) for v in args), torch.from_numpy(edges), depth, C)
        want = jax_toad_bits(jnp.asarray(used_feat), jnp.asarray(used_thr),
                             *(jnp.asarray(v, jnp.int32) for v in args),
                             jnp.asarray(edges), depth, C)
        assert int(got) == int(want)


@pytest.mark.parametrize("task,n_classes", [("regression", 0), ("binary", 0),
                                            ("multiclass", 3)])
def test_losses_match_jax(task, n_classes):
    rng = np.random.default_rng(4)
    n = 257
    C = max(n_classes, 1)
    preds = rng.normal(size=(n, C)).astype(np.float32)
    if task == "regression":
        y = rng.normal(size=n).astype(np.float32)
    else:
        y = rng.integers(0, max(n_classes, 2), n).astype(np.float32)
    port, jax_loss = make_loss(task, n_classes), jax_make_loss(task, n_classes)
    assert port.n_ensembles == jax_loss.n_ensembles == C
    ty, tp = torch.from_numpy(y), torch.from_numpy(preds)
    jy, jp = jnp.asarray(y), jnp.asarray(preds)
    for got, want in zip(port.grad_hess(ty, tp), jax_loss.grad_hess(jy, jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for got, want in zip(port.base_stats(ty), jax_loss.base_stats(jy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(port.base_score(ty).numpy(),
                               np.asarray(jax_loss.base_score(jy)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(port.metric(ty, tp)),
                               float(jax_loss.metric(jy, jp)), rtol=1e-6)
    with pytest.raises(ValueError):
        make_loss("ranking")


def test_train_grid_equals_single_runs(runs):
    X, y, edges, bins, *_ = runs("binary-penalised")
    cfg = GBDTConfig(**BINARY)
    pf, pt, fs = (torch.tensor(v) for v in ([0.0, 4.0, 1.0], [0.0, 1.0, 0.5],
                                            [0.0, 0.0, 400.0]))
    grid, hists, auxes = train_grid(cfg, bins, torch.from_numpy(y),
                                    torch.from_numpy(edges), pf, pt, fs)
    assert grid.feature.shape[0] == 3
    for i in range(3):
        f, h, a = train(cfg, bins, torch.from_numpy(y), torch.from_numpy(edges),
                        float(pf[i]), float(pt[i]), float(fs[i]))
        for k in STRUCTURE + ("leaf_values", "base_score"):
            assert torch.equal(getattr(grid, k)[i], getattr(f, k)), k
        for k in h:
            assert torch.equal(hists[k][i], h[k]), k
        assert torch.equal(auxes["toad_bytes"][i], a["toad_bytes"])


@pytest.mark.parametrize("subtract", [True, False])
def test_hist_methods_grow_identical_trees(runs, subtract):
    X, y, edges, bins, *_ = runs("binary-penalised")
    base = GBDTConfig(**BINARY, toad_penalty_feature=0.5, toad_penalty_threshold=0.1)
    ref_cfg = dataclasses.replace(base, hist_method="ref", hist_subtract=False)
    f_ref, h_ref, _ = train(ref_cfg, bins, torch.from_numpy(y), torch.from_numpy(edges))
    for method in ("ref", "fused", "cuda", "auto", "pallas"):
        cfg = dataclasses.replace(base, hist_method=method, hist_subtract=subtract)
        f, h, _ = train(cfg, bins, torch.from_numpy(y), torch.from_numpy(edges))
        for k in STRUCTURE:
            assert torch.equal(getattr(f, k), getattr(f_ref, k)), (method, k)
        np.testing.assert_allclose(f.leaf_values.numpy(), f_ref.leaf_values.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=method)


def test_refusals(runs):
    X, y, edges, bins, *_ = runs("binary-penalised")
    args = (bins, torch.from_numpy(y), torch.from_numpy(edges))
    for kw in (dict(axis_name="data"), dict(hist_quant_bits=8)):
        with pytest.raises(NotImplementedError, match="slice 8"):
            train(GBDTConfig(**BINARY), *args, **kw)
    with pytest.raises(ValueError, match="unknown histogram method"):
        train(GBDTConfig(**BINARY, hist_method="mxu"), *args)


def test_round_loop_reads_nothing_back(runs, monkeypatch):
    """Every way a tensor's value reaches the host raises during ``train``:
    the loop only queues work, so on the card it never waits for it."""
    X, y, edges, bins, *_ = runs("binary-penalised")
    args = (GBDTConfig(**BINARY, toad_forestsize=400.0, leaf_quant=0.02), bins,
            torch.from_numpy(y), torch.from_numpy(edges))

    def refuse(self, *a, **k):
        raise AssertionError("read back to the host")

    for attr in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    forest, history, aux = train(*args)
    monkeypatch.undo()
    assert int(forest.n_trees) >= 1 and history["bytes"].shape == (16,)


def test_block_sums_take_xla_order():
    """The fixed summation orders equal jnp.cumsum / jnp.sum to the bit
    (power-of-two lengths for the sum) and torch's own within rounding."""
    rng = np.random.default_rng(0)
    for shape in [(64, 8, 256), (3, 7, 64), (5, 33), (9, 16), (2, 1)]:
        a = (10 * rng.normal(size=shape)).astype(np.float32)
        got = block_cumsum(torch.from_numpy(a)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.cumsum(jnp.asarray(a), -1)))
        np.testing.assert_allclose(got, np.cumsum(a.astype(np.float64), -1),
                                   rtol=1e-4, atol=1e-3)
    for shape in [(64, 256), (3, 64), (4, 32), (7, 16), (2, 1)]:
        a = (10 * rng.normal(size=shape)).astype(np.float32)
        got = block_sum(torch.from_numpy(a)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.sum(jnp.asarray(a), -1)))
