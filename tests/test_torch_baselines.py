"""The port's baselines (``repro_torch.gbdt.baselines``) against the JAX
package's, on the CPU.

The first five tests are the counterparts of ``tests/test_baselines.py``,
on its data, with the port's trainer.  The parity tests carry one JAX
``train_jit`` forest (one configuration for the module) across with
``forest_from_numpy`` and hold each transform's arrays equal to JAX's:
``quantize_forest``, ``shared_table_forest``, ``ccp_prune`` (with the JAX
run's ``node_gain`` and ``leaf_cnt``), ``take_trees``; ``rf_predict`` within
1e-5.  The random forest's draws cannot be JAX's (``jax.random`` is not
torch's generator), so its trees are held two ways: the port's draws
replayed through the JAX package's ``_grow_tree`` give the port's trees
tree by tree (structure equal, leaf values within 1e-5), and, as a
statistical contract on independent draws, the port's ``train_rf``
accuracy is within 0.02 of JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gbdt import GBDTConfig as JaxConfig
from repro.gbdt import train_jit
from repro.gbdt import baselines as jax_baselines
from repro.gbdt.trainer import _grow_tree as jax_grow_tree

from repro_torch.core import compression_summary
from repro_torch.gbdt import (
    FOREST_FIELDS,
    GBDTConfig,
    apply_bins,
    fit_bins,
    forest_from_numpy,
    forest_to_numpy,
    predict_binned,
    train,
)
from repro_torch.gbdt.baselines import (
    RFConfig,
    ccp_prune,
    cegb_config,
    margin_diversity_order,
    quantize_forest,
    rf_bits,
    rf_draws,
    rf_predict,
    shared_table_forest,
    take_trees,
    train_rf,
)

JAX_FIT = dict(task="binary", n_rounds=16, max_depth=4)
RF = RFConfig(task="binary", n_trees=16, max_depth=4)
RF_JAX = jax_baselines.RFConfig(**dataclasses.asdict(RF))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    n, d = 2000, 10
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] * 1.3 - X[:, 1] + 0.5 * X[:, 2] > 0).astype(np.float32)
    edges = torch.from_numpy(fit_bins(X, 32))
    return apply_bins(torch.from_numpy(X), edges), torch.from_numpy(y), edges


def _acc(f, bins, y):
    return float(((predict_binned(f, bins)[:, 0] > 0) == y).float().mean())


# ---- the counterparts of tests/test_baselines.py ---------------------------


def test_quantized_keeps_quality(data):
    bins, y, edges = data
    cfg = GBDTConfig(task="binary", n_rounds=20, max_depth=3)
    f, _, _ = train(cfg, bins, y, edges)
    assert _acc(quantize_forest(f), bins, y) > _acc(f, bins, y) - 0.02


def test_cegb_reduces_splits(data):
    bins, y, edges = data
    base = GBDTConfig(task="binary", n_rounds=20, max_depth=3)
    f0, h0, _ = train(base, bins, y, edges)
    f1, h1, _ = train(cegb_config(base, tradeoff=64.0), bins, y, edges)
    assert int(h1["n_splits"][-1]) < int(h0["n_splits"][-1])
    assert _acc(f1, bins, y) > 0.85


def test_ccp_prunes_and_predicts(data):
    bins, y, edges = data
    cfg = GBDTConfig(task="binary", n_rounds=16, max_depth=4)
    f, h, aux = train(cfg, bins, y, edges)
    fp = ccp_prune(f, aux["node_gain"], aux["leaf_cnt"], alpha=2.0)
    s0 = int(f.is_split[: int(f.n_trees)].sum())
    s1 = int(fp.is_split[: int(fp.n_trees)].sum())
    assert s1 < s0
    assert _acc(fp, bins, y) > 0.8
    assert fp.device == f.device


def test_rf_trains(data):
    bins, y, edges = data
    rf, n_splits = train_rf(RF, bins, y, edges)
    acc = float(((rf_predict(rf, bins)[:, 0] > 0.5) == y).float().mean())
    assert acc > 0.85
    assert n_splits > 0


def test_toad_beats_baselines_at_same_quality(data):
    """The core paper claim, in miniature: at comparable accuracy the ToaD
    stream is several times smaller than the fp32 pointer layout."""
    bins, y, edges = data
    cfg = GBDTConfig(task="binary", n_rounds=24, max_depth=3,
                     toad_penalty_feature=2.0, toad_penalty_threshold=0.5)
    f, _, _ = train(cfg, bins, y, edges)
    s = compression_summary(f)
    assert _acc(f, bins, y) > 0.9
    assert s["compression_vs_f32"] > 3.0


# ---- parity with the JAX package --------------------------------------------


@pytest.fixture(scope="module")
def jax_fit(data):
    """One JAX ``train_jit`` fit: its forest, the same forest in the port,
    and JAX's aux."""
    bins, y, edges = data
    f, _, aux = train_jit(JaxConfig(**JAX_FIT), jnp.asarray(bins.numpy()),
                          jnp.asarray(y.numpy()), jnp.asarray(edges.numpy()))
    port = forest_from_numpy({k: np.asarray(getattr(f, k)) for k in FOREST_FIELDS},
                             f.n_ensembles, device="cpu")
    return f, port, jax.tree.map(np.asarray, aux)


def _equal_forests(port, jf, label):
    got = forest_to_numpy(port)
    for k in FOREST_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jf, k)), err_msg=f"{label}: {k}")
    assert port.n_ensembles == jf.n_ensembles


def test_cegb_config_fields_equal_jax():
    base = dict(task="binary", n_rounds=20, max_depth=3, toad_penalty_threshold=0.5)
    for tradeoff, split in ((64.0, 0.25), (8.0, 0.5)):
        port = dataclasses.asdict(cegb_config(GBDTConfig(**base), tradeoff, split))
        want = dataclasses.asdict(jax_baselines.cegb_config(JaxConfig(**base), tradeoff, split))
        assert port == want


def test_quantize_forest_equals_jax(jax_fit):
    jf, port, _ = jax_fit
    _equal_forests(quantize_forest(port), jax_baselines.quantize_forest(jf), "quantized")


@pytest.mark.parametrize("bits", [6, 3])
def test_shared_table_forest_equals_jax(jax_fit, bits):
    jf, port, _ = jax_fit
    _equal_forests(shared_table_forest(port, bits=bits),
                   jax_baselines.shared_table_forest(jf, bits=bits), f"shared {bits}")


@pytest.mark.parametrize("alpha", [0.5, 2.0, 8.0])
def test_ccp_prune_equals_jax(jax_fit, alpha):
    jf, port, aux = jax_fit
    got = ccp_prune(port, torch.tensor(aux["node_gain"]), torch.tensor(aux["leaf_cnt"]),
                    alpha)
    want = jax_baselines.ccp_prune(jf, aux["node_gain"], aux["leaf_cnt"], alpha)
    _equal_forests(got, want, f"alpha {alpha}")
    assert int(got.is_split.sum()) < int(port.is_split.sum())


def test_take_trees_equals_jax(jax_fit):
    jf, port, _ = jax_fit
    idx = np.array([5, 0, 15, 3, 3])
    _equal_forests(take_trees(port, idx), jax_baselines.take_trees(jf, idx), "take_trees")


@pytest.mark.parametrize("n_splits,n_trees,n_classes", [(0, 1, 1), (230, 16, 1), (97, 12, 3)])
def test_rf_bits_equals_jax(n_splits, n_trees, n_classes):
    assert rf_bits(n_splits, n_trees, n_classes) == jax_baselines.rf_bits(n_splits, n_trees,
                                                                          n_classes)


def test_margin_diversity_order_equals_jax():
    rng = np.random.default_rng(4)
    y = rng.integers(0, 2, size=300)
    tree_preds = np.where(rng.random((12, 300)) < 0.75, y, 1 - y)
    order = margin_diversity_order(tree_preds, y)
    np.testing.assert_array_equal(order, jax_baselines.margin_diversity_order(tree_preds, y))
    assert sorted(order.tolist()) == list(range(12))


@pytest.fixture(scope="module")
def rf_runs(data):
    """The port's and the JAX package's ``train_rf`` on the same data."""
    bins, y, edges = data
    port = train_rf(RF, bins, y, edges)
    jax_run = jax_baselines.train_rf(RF_JAX, jnp.asarray(bins.numpy()), jnp.asarray(y.numpy()),
                                     jnp.asarray(edges.numpy()))
    return port, jax_run



def test_rf_predict_equals_jax_on_the_same_forest(data, rf_runs):
    bins, y, edges = data
    (jf, _) = rf_runs[1]
    port = forest_from_numpy({k: np.asarray(getattr(jf, k)) for k in FOREST_FIELDS},
                             jf.n_ensembles, device="cpu")
    want = np.asarray(jax_baselines.rf_predict(jf, jnp.asarray(bins.numpy())))
    np.testing.assert_allclose(rf_predict(port, bins).numpy(), want, rtol=0, atol=1e-5)


def test_rf_trees_equal_jax_grow_tree_on_the_port_s_draws(data, rf_runs):
    """Replay: each of the port's (weights, feature mask) draws through the
    JAX package's ``_grow_tree``, as its ``train_rf`` calls it."""
    bins, y, edges = data
    (rf, n_splits), _ = rf_runs
    n, d = bins.shape
    E = edges.shape[1]
    L = 2 ** RF.max_depth
    gcfg = JaxConfig(task="regression", n_rounds=1, max_depth=RF.max_depth, learning_rate=1.0,
                     reg_lambda=RF.reg_lambda, min_child_samples=RF.min_child_samples,
                     leaf_capacity=RF.n_trees * L)
    grow = jax.jit(jax_grow_tree, static_argnums=0)
    jbins, jy, jedges = (jnp.asarray(t.numpy()) for t in (bins, y, edges))
    values = rf.leaf_values.numpy().reshape(RF.n_trees, L)
    total = 0
    for t, (w, keep) in enumerate(rf_draws(RF, n, d, seed=0)):
        w = jnp.asarray(w.numpy())
        masked = jnp.where(jnp.asarray(keep.numpy())[:, None], jedges, jnp.inf)
        state = (jnp.zeros((d,), bool), jnp.zeros((d, E), bool), jnp.zeros((L,), jnp.float32),
                 jnp.zeros((), jnp.int32), jnp.float32(0.0), jnp.float32(0.0))
        tree, _, n_sp, state = grow(gcfg, jbins, -w * jy, w, masked, state)
        for i, k in enumerate(("feature", "thr_bin", "is_split")):
            np.testing.assert_array_equal(getattr(rf, k)[t].numpy(), np.asarray(tree[i]),
                                          err_msg=f"tree {t}: {k}")
        np.testing.assert_allclose(values[t], np.asarray(state[2])[np.asarray(tree[3])],
                                   rtol=0, atol=1e-5, err_msg=f"tree {t}")
        total += int(n_sp)
    assert total == n_splits


def test_rf_accuracy_within_two_points_of_jax(data, rf_runs):
    """A statistical contract: independent draws, the same recipe."""
    bins, y, edges = data
    (rf, _), (jf, _) = rf_runs
    acc = float(((rf_predict(rf, bins)[:, 0] > 0.5) == y).float().mean())
    jacc = float(np.mean((np.asarray(jax_baselines.rf_predict(jf, jnp.asarray(bins.numpy())))[:, 0]
                          > 0.5) == y.numpy()))
    assert abs(acc - jacc) <= 0.02


def test_rf_draws_share_one_stream_and_are_seeded():
    a = list(rf_draws(RF, 50, 7, seed=3))
    b = list(rf_draws(RF, 50, 7, seed=3))
    c = list(rf_draws(RF, 50, 7, seed=4))
    assert len(a) == RF.n_trees
    for (wa, ka), (wb, kb) in zip(a, b):
        assert torch.equal(wa, wb) and torch.equal(ka, kb)
        assert wa.dtype == torch.float32 and ka.dtype == torch.bool
    assert not all(torch.equal(wa, wc) for (wa, _), (wc, _) in zip(a, c))
    assert not torch.equal(a[0][0], a[1][0])  # each tree draws anew
