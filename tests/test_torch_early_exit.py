"""The port's early-exit serving slice against the JAX package, on the CPU.

Same inputs, drawn with numpy from a seed, through both packages:
``core.treeorder`` (bound tables bit-equal), ``gbdt.early_exit`` (policy,
tie rule, reference evaluator), the CUDA early-exit kernel's plain version
against the JAX Pallas kernel run in interpret mode (trees evaluated and
exits exactly equal, labels exact, non-exited scores within 1e-6), the
``EarlyExitPredictor`` modes and engine counters, and the ``early_exit``
section of the ``.toad`` meta in both directions."""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.api import EarlyExitPolicy as JaxPolicy
from repro.api import ToadModel as JaxToadModel
from repro.api.artifact import load_checked as jax_load_checked
from repro.api.engine import EarlyExitPredictor as JaxPredictor
from repro.core import treeorder as jto
from repro.gbdt import early_exit as jee
from repro.kernels.ops import predict_packed_model_early_exit as jax_ee

from repro_torch._device import host
from repro_torch.api import (
    EarlyExitPolicy,
    EarlyExitPredictor,
    GBDTEngine,
    ToadModel,
    backends,
)
from repro_torch.core import treeorder as pto
from repro_torch.gbdt import FOREST_FIELDS, GBDTConfig, forest_from_numpy
from repro_torch.gbdt import early_exit as pee
from repro_torch.kernels.ops import predict_packed_model_early_exit
from repro_torch.kernels.predict import (
    _round_up_f32,
    device_exit_tables,
    exit_tables,
    packed_predict_early_exit,
    tree_block_for,
)


# ---------------------------------------------------------------- fixtures
def _fit(task, n_classes, seed, rounds=12, n=256, d=6):
    """tests/test_early_exit.py's model: a JAX ToadModel and its rows."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if task == "binary":
        y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    else:
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    m = JaxToadModel(task=task, n_classes=n_classes, n_bins=16,
                     n_rounds=rounds, max_depth=2, learning_rate=0.4)
    return m.fit(X, y).compress(), X


def _port(jm) -> ToadModel:
    """The JAX model's forest in the port, compressed there."""
    arrays = {f: np.asarray(getattr(jm.forest, f)) for f in FOREST_FIELDS}
    forest = forest_from_numpy(arrays, jm.forest.n_ensembles, device="cpu")
    config = GBDTConfig(**dataclasses.asdict(jm.config))
    return ToadModel.from_forest(forest, config, n_bins=jm.n_bins,
                                 device="cpu").compress()


@pytest.fixture(scope="module")
def models():
    """One binary (12 trees) and one 3-class (36 trees) model, both
    packages, built once."""
    out = {}
    for task, n_classes, seed in (("binary", 0, 0), ("multiclass", 3, 1)):
        jm, X = _fit(task, n_classes, seed)
        out[task] = (jm, _port(jm), X)
    return out


def _hand_forest(leaf_vals, C=1, base=0.0):
    """tests/test_early_exit.py's depth-1 all-unsplit forest: tree t lands
    on ``leaf_vals[t]``; 0-d n_trees/n_ensembles on purpose."""
    T = len(leaf_vals)
    return SimpleNamespace(
        n_trees=np.array(T), n_ensembles=np.array(C),
        feature=np.zeros((T, 1), np.int32),
        thr_bin=np.zeros((T, 1), np.int32),
        is_split=np.zeros((T, 1), bool),
        leaf_ref=np.tile(np.array([[0, 1]], np.int32), (T, 1))
        + 2 * np.arange(T, dtype=np.int32)[:, None],
        leaf_values=np.stack([np.float32(v) for v in leaf_vals
                              for _ in (0, 1)]).astype(np.float32),
        edges=np.zeros((1, 1), np.float32),
        base_score=np.full(C, base, np.float64),
    )


def _unreachable():
    f = _hand_forest([1.0, 1.0])
    f.leaf_values[3] = 1e6  # the right child of tree 1's unsplit root
    return f


HAND = {
    "zero-split": lambda: _hand_forest([2.0, 0.5, 0.25]),
    "single-tree": lambda: _hand_forest([3.0]),
    "tie": lambda: _hand_forest([1.0, -1.0]),
    "unreachable-leaf": _unreachable,
    "multiclass-hand": lambda: _hand_forest([0.5, -0.25, 1.0, 0.125, -2.0, 0.75], C=3),
}


# ------------------------------------------------------------ core.treeorder
def _treeorder_outputs(mod, forest, order):
    return {
        "reachable_leaf_mask": mod.reachable_leaf_mask(
            host(forest.is_split)[: int(forest.n_trees)]),
        "tree_mass": mod.tree_mass(forest),
        "tree_max_step": mod.tree_max_step(forest),
        "order": mod.tree_order_most_informative(forest),
        "remaining_mass": mod.remaining_mass(forest),
        "remaining_mass_permuted": mod.remaining_mass(forest, order),
    }


@pytest.mark.parametrize("case", ["binary", "multiclass", "0-d-duck", *sorted(HAND)])
def test_treeorder_is_bit_equal_to_jax(models, case):
    if case in ("binary", "multiclass"):
        jm, pm, _ = models[case]
        jforest, pforest = jm.forest, pm.forest
    elif case == "0-d-duck":
        f = models["binary"][0].forest
        jforest = pforest = SimpleNamespace(
            n_trees=np.array(int(f.n_trees)), n_ensembles=np.array(int(f.n_ensembles)),
            is_split=np.asarray(f.is_split), leaf_ref=np.asarray(f.leaf_ref),
            leaf_values=np.asarray(f.leaf_values))
    else:
        jforest = pforest = HAND[case]()
    T = int(jforest.n_trees)
    order = np.random.default_rng(T).permutation(T).astype(np.int64)
    want = _treeorder_outputs(jto, jforest, order)
    got = _treeorder_outputs(pto, pforest, order)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_suffix_bound_is_bit_equal_and_refuses_negative_steps():
    rng = np.random.default_rng(5)
    step = rng.random(17) * 10.0 ** rng.integers(-6, 3, 17)
    cls = np.arange(17) % 3
    np.testing.assert_array_equal(pto.suffix_bound(step, cls, 3),
                                  jto.suffix_bound(step, cls, 3))
    for mod in (pto, jto):
        with pytest.raises(ValueError):
            mod.suffix_bound(np.array([1.0, -0.5]), np.array([0, 0]), 1)
        with pytest.raises(ValueError, match="permutation"):
            mod.remaining_mass(_hand_forest([1.0, 2.0]), np.array([0, 0]))


# ------------------------------------------------------------------- policy
POLICIES = [
    {},
    {"epsilon": float("inf")},
    {"epsilon": 0.5, "min_trees": 2, "max_trees": 7, "guard": 0.0},
    {"per_class_epsilon": (0.0, float("inf"), 1.5)},
]


@pytest.mark.parametrize("kw", POLICIES)
def test_policy_dicts_are_equal_both_ways(kw):
    p, j = EarlyExitPolicy(**kw), JaxPolicy(**kw)
    assert p.to_dict() == j.to_dict()
    # through JSON, each package reads the other's dict
    assert EarlyExitPolicy.from_dict(json.loads(json.dumps(j.to_dict()))) == p
    assert JaxPolicy.from_dict(json.loads(json.dumps(p.to_dict()))) == j
    assert p.never_exits == j.never_exits
    C = 3
    np.testing.assert_array_equal(p.slack(C), j.slack(C))


@pytest.mark.parametrize("kw", [
    {"epsilon": -1.0}, {"epsilon": float("nan")}, {"min_trees": -1},
    {"max_trees": 0}, {"guard": -0.5}, {"per_class_epsilon": (-1.0,)},
])
def test_policy_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError) as want:
        JaxPolicy(**kw)
    with pytest.raises(ValueError) as got:
        EarlyExitPolicy(**kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="entries for 2 classes"):
        EarlyExitPolicy(per_class_epsilon=(0.0, 1.0, 2.0)).slack(2)


# --------------------------------------------------------- the tie rule
def _mask_inputs(C, seed):
    """Random scores plus rows that sit exactly on the bound."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(scale=2.0, size=(300, C))
    rem = rng.random(C) * 1.5
    slack = rng.random(C) * 0.1
    if C == 1:
        g = slack[0]
        ties = np.array([[rem[0] + g], [-(rem[0] + g)], [0.0], [rem[0]]])
    else:
        need = rem[1] + rem[0] + slack[1]
        # the leader 1 tied against a lower (0) and a higher (2) challenger
        ties = np.array([[0.0, need, -9.0], [-9.0, need, 0.0 + rem[2] - rem[0]],
                         [1.0, 1.0, 1.0], [0.0, need + 1e-12, -9.0]])
    return np.concatenate([scores, ties]), rem, slack


@pytest.mark.parametrize("guard", [0.0, 1e-4])
@pytest.mark.parametrize("C", [1, 3])
def test_decision_final_mask_matches_jax(C, guard):
    scores, rem, slack = _mask_inputs(C, seed=C)
    want64 = jee.decision_final_mask(scores, rem, slack, guard)
    np.testing.assert_array_equal(pee.decision_final_mask(scores, rem, slack, guard),
                                  want64)
    # float32, as the kernels evaluate it: the port on torch tensors, JAX on
    # numpy float32 (the Pallas kernel's operands)
    s32, r32, k32 = (a.astype(np.float32) for a in (scores, rem, slack))
    want32 = jee.decision_final_mask(s32, r32, k32, guard)
    got32 = pee.decision_final_mask(torch.from_numpy(s32), torch.from_numpy(r32),
                                    torch.from_numpy(k32), guard)
    np.testing.assert_array_equal(got32.numpy(), want32)
    assert want64.any() and not want64.all()


# ----------------------------------------------------- reference evaluator
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_predict_early_exit_matches_jax(models, task):
    jm, pm, X = models[task]
    for kw in ({}, {"check_every": 8}):
        for policy in ({"epsilon": 0.0}, {"epsilon": 0.0, "min_trees": 5},
                       {"epsilon": 0.2, "max_trees": 7}):
            want = jee.predict_early_exit(jm.forest, X, JaxPolicy(**policy), **kw)
            got = pee.predict_early_exit(pm.forest, X, EarlyExitPolicy(**policy), **kw)
            np.testing.assert_array_equal(got.scores, want.scores)
            np.testing.assert_array_equal(got.trees_evaluated, want.trees_evaluated)
            np.testing.assert_array_equal(got.exited, want.exited)
            assert got.mean_trees_evaluated == want.mean_trees_evaluated
            assert got.frac_exited == want.frac_exited


# --------------------------- the kernel's plain version vs the Pallas kernel
def _truncated(jm, pm, T):
    """Both packages' packed model and forest cut to the first T trees."""
    jpacked = dataclasses.replace(jm.packed, words=np.asarray(jm.packed.words)[:T],
                                  leaf_ref=np.asarray(jm.packed.leaf_ref)[:T])
    pdev = pm.device_packed()
    pdev = dataclasses.replace(pdev, words=pdev.words[:T], leaf_ref=pdev.leaf_ref[:T])
    forest = SimpleNamespace(**{f: np.asarray(getattr(jm.forest, f))
                                for f in ("is_split", "leaf_ref", "leaf_values")},
                             n_trees=T, n_ensembles=jm.forest.n_ensembles)
    return jpacked, pdev, jto.remaining_mass(forest)


KERNEL_CASES = {
    # name: (task, T or None for all, rows, slack, min_trees, base shift)
    "T5": ("binary", 5, "fit", 0.0, 0, 0.0),
    "T8": ("binary", 8, "fit", 0.0, 0, 0.0),
    "T12": ("binary", 12, "fit", 0.0, 0, 0.0),
    "all-exit-block-0": ("binary", 12, "fit", 0.0, 0, 10.0),
    "no-exit": ("binary", 12, "fit", 1e9, 0, 0.0),
    "min-trees-9": ("binary", 12, "fit", 0.0, 9, 0.0),
    "multiclass": ("multiclass", None, "fit", 0.0, 0, 0.0),
    "multiclass-min-trees-10": ("multiclass", None, "fit", 0.0, 10, 0.0),
    "nan": ("binary", 12, "nan", 0.0, 0, 0.0),
    "multiclass-nan": ("multiclass", None, "nan", 0.0, 0, 0.0),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_version_matches_the_pallas_kernel(models, case):
    task, T, rows, slack, min_trees, shift = KERNEL_CASES[case]
    jm, pm, X = models[task]
    C = int(jm.forest.n_ensembles)
    T = T or int(jm.forest.n_trees)
    jpacked, pdev, bound = _truncated(jm, pm, T)
    if shift:
        jpacked = dataclasses.replace(
            jpacked, base_score=np.asarray(jpacked.base_score) + np.float32(shift))
        pdev = dataclasses.replace(pdev, base_score=pdev.base_score + shift)
    x = X[:200].copy()
    if rows == "nan":
        x[np.random.default_rng(3).random(x.shape) < 0.1] = np.nan
    guard = JaxPolicy().guard
    slack = np.full(C, slack)
    js, jt, jx = jax_ee(jpacked, x, bound, slack, guard=guard, min_trees=min_trees)
    js = np.asarray(js)
    ps, pt, px = predict_packed_model_early_exit(pdev, x, bound, slack, guard=guard,
                                                 min_trees=min_trees, device="cpu")
    ps, pt, px = ps.numpy(), pt.numpy(), px.numpy()
    assert pt.dtype == np.int32 and px.dtype == bool and ps.shape == (200, C)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(px, jx)
    task_labels = lambda s: jee.predict_label_from_scores(s, task)
    np.testing.assert_array_equal(task_labels(ps), task_labels(js))
    full, _, _ = predict_packed_model_early_exit(pdev, x, bound, np.full(C, np.inf),
                                                 device="cpu")
    np.testing.assert_array_equal(task_labels(ps), task_labels(full.numpy()))
    np.testing.assert_allclose(ps[~px], js[~px], rtol=0, atol=1e-6)
    # non-exited rows equal the same function with exits disabled to the bit
    np.testing.assert_array_equal(ps[~px], full.numpy()[~px])
    tb = tree_block_for(C)
    assert np.all(pt[px] % tb == 0) and np.all(pt[~px] == T)
    if case == "all-exit-block-0":
        assert px.all() and np.all(pt == tb)
    if case == "no-exit":
        assert not px.any()
    if min_trees:
        assert np.all(pt[px] >= min_trees)
    if case in ("T12", "multiclass", "nan"):
        assert px.any() and not px.all()


def test_exit_tables_round_up_and_hold_min_trees():
    rng = np.random.default_rng(1)
    T, C = 13, 1
    bound = np.sort(rng.random((T + 1, C)) * 3.0, axis=0)[::-1].copy()
    bound[-1] = 0.0
    rem, slack = exit_tables(bound, [1e-9 / 3], n_trees=T, n_ensembles=C, min_trees=9)
    assert rem.dtype == slack.dtype == np.float32 and rem.shape == (2, 1)
    assert rem[0, 0] == np.inf  # boundary 8 < min_trees
    assert rem[1, 0] == 0.0  # boundary T
    assert slack[0] >= 1e-9 / 3
    x64 = rng.random(1000) * 10.0 ** rng.integers(-20, 20, 1000)
    from repro.kernels.predict import _round_up_f32 as jax_round_up

    np.testing.assert_array_equal(_round_up_f32(x64), jax_round_up(x64))
    assert np.all(_round_up_f32(x64).astype(np.float64) >= x64)
    with pytest.raises(ValueError, match="bound table shape"):
        exit_tables(bound[:-1], [0.0], n_trees=T, n_ensembles=C)


def test_zero_tree_and_empty_batch_return_without_work(models):
    jm, pm, X = models["binary"]
    _, pdev, _ = _truncated(jm, pm, 0)
    s, t, e = predict_packed_model_early_exit(pdev, X[:7], np.zeros((1, 1)), [0.0],
                                              device="cpu")
    np.testing.assert_array_equal(s.numpy(), np.broadcast_to(pdev.base_score.numpy(), (7, 1)))
    assert t.dtype == torch.int32 and not t.any() and not e.any()
    s, t, e = predict_packed_model_early_exit(pm.device_packed(), X[:0],
                                              jto.remaining_mass(jm.forest), [0.0],
                                              device="cpu")
    assert s.shape == (0, 1) and t.shape == e.shape == (0,)


def test_wrapper_refuses_what_the_kernel_does_not_take(models):
    jm, pm, X = models["binary"]
    dev = pm.device_packed()
    bound = jto.remaining_mass(jm.forest)
    x = torch.from_numpy(X[:4])
    with pytest.raises(ValueError, match="packed_predict_early_exit"):
        packed_predict_early_exit(x.double(), *dev.arrays(), bound, [0.0], **dev.meta())
    with pytest.raises(ValueError, match="bound table shape"):
        packed_predict_early_exit(x, *dev.arrays(), bound[1:], [0.0], **dev.meta())
    with pytest.raises(ValueError, match="slack shape"):
        packed_predict_early_exit(x, *dev.arrays(), bound, [0.0, 0.0], **dev.meta())
    tables = device_exit_tables(bound, [0.0], n_trees=dev.words.shape[0], n_ensembles=1)
    with pytest.raises(ValueError, match="not both"):
        packed_predict_early_exit(x, *dev.arrays(), bound, [0.0], **dev.meta(),
                                  tables=tables)
    with pytest.raises(ValueError, match="rem_blocks"):
        packed_predict_early_exit(x, *dev.arrays(), **dev.meta(),
                                  tables=(tables[0][1:], tables[1]))
    with pytest.raises(ValueError, match="slack"):
        packed_predict_early_exit(x, *dev.arrays(), **dev.meta(),
                                  tables=(tables[0], tables[1].double()))


@pytest.mark.parametrize("min_trees", [0, 9])
def test_tables_made_once_give_the_per_call_result(models, min_trees):
    """Serving makes the exit tables once; a batch given them computes what
    a batch given the host bound computes."""
    jm, pm, X = models["multiclass"]
    dev = pm.device_packed()
    T, C = dev.words.shape[0], dev.n_ensembles
    bound = jto.remaining_mass(jm.forest)
    slack = EarlyExitPolicy(epsilon=0.0).slack(C)
    tables = device_exit_tables(bound, slack, n_trees=T, n_ensembles=C,
                                min_trees=min_trees)
    rem, slack32 = exit_tables(bound, slack, n_trees=T, n_ensembles=C, min_trees=min_trees)
    np.testing.assert_array_equal(tables[0].numpy(), rem)
    np.testing.assert_array_equal(tables[1].numpy(), slack32)
    want = predict_packed_model_early_exit(dev, X, bound, slack, guard=1e-4,
                                           min_trees=min_trees, device="cpu")
    got = predict_packed_model_early_exit(dev, X, tables=tables, guard=1e-4, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------ EarlyExitPredictor
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_predictor_modes_match_jax(models, task):
    jm, pm, X = models[task]
    policy = {"epsilon": 0.0}
    full = pm.predict(X, backend="packed")
    labels = lambda s: jee.predict_label_from_scores(np.asarray(s), task)

    ref = EarlyExitPredictor(pm, EarlyExitPolicy(**policy), backend="reference")
    jref = JaxPredictor(jm, JaxPolicy(**policy), backend="reference")
    assert ref.mode == jref.mode == "reference"
    got = ref(X)
    np.testing.assert_array_equal(got, np.asarray(jref(X)))
    assert ref.mean_trees_evaluated() == jref.mean_trees_evaluated()
    assert ref.rows_counted() == jref.rows_counted() == len(X)

    # the JAX package's "staged" mode has no counterpart: the port's packed
    # mode is the kernel's plain version, the very function of kernel mode
    packed = EarlyExitPredictor(pm, EarlyExitPolicy(**policy), backend="packed")
    assert packed.mode == "packed"
    got = packed(X)
    np.testing.assert_array_equal(labels(got), labels(full))
    C = int(pm.forest.n_ensembles)
    ws, wt, _ = predict_packed_model_early_exit(
        pm.device_packed(), X, jto.remaining_mass(jm.forest),
        EarlyExitPolicy(**policy).slack(C), guard=EarlyExitPolicy(**policy).guard,
        device="cpu")
    assert torch.equal(got, ws)
    assert packed.mean_trees_evaluated() == float(wt.double().mean())
    assert packed.mean_trees_evaluated() < int(pm.forest.n_trees)
    capped = EarlyExitPredictor(pm, EarlyExitPolicy(epsilon=0.0, max_trees=9),
                                backend="packed")
    capped(X)
    assert capped.mean_trees_evaluated() <= 9
    packed.reset()
    assert packed.mean_trees_evaluated() == 0.0 and packed.rows_counted() == 0


def test_epsilon_inf_and_zero_trees_are_full_evaluation(models):
    jm, pm, X = models["binary"]
    adapter = EarlyExitPredictor(pm, EarlyExitPolicy(epsilon=float("inf")),
                                 backend="packed")
    assert adapter.mode == "full"
    assert torch.equal(adapter(X), pm.predictor("packed")(X))
    assert adapter.mean_trees_evaluated() == int(pm.forest.n_trees)
    empty = ToadModel.from_forest(
        dataclasses.replace(pm.forest, n_trees=torch.tensor(0, dtype=torch.int32)),
        pm.config, n_bins=pm.n_bins, device="cpu")
    assert EarlyExitPredictor(empty, EarlyExitPolicy(), backend="reference").mode == "full"


def test_predictor_refuses_regression(models):
    _, pm, _ = models["binary"]
    reg = ToadModel.from_forest(pm.forest, GBDTConfig(task="regression"), n_bins=16,
                                device="cpu")
    with pytest.raises(ValueError, match="regression"):
        EarlyExitPredictor(reg, EarlyExitPolicy())


@pytest.mark.parametrize("max_trees", [None, 9])
def test_kernel_mode_runs_the_wrapper_and_sums_trees_on_the_device(
        monkeypatch, models, max_trees):
    """The ``cuda`` backend's mode, driven on the CPU: with the card check
    patched, the kernel wrapper runs its plain version."""
    monkeypatch.setattr(backends, "_hopper", lambda device: True)
    jm, pm, X = models["multiclass"]
    policy = EarlyExitPolicy(epsilon=0.0, max_trees=max_trees)
    adapter = EarlyExitPredictor(pm, policy, backend="cuda")
    assert adapter.mode == "kernel"
    got = adapter(X)
    T = max_trees or int(pm.forest.n_trees)
    bound = jto.remaining_mass(jm.forest)[: T + 1]
    jpacked = dataclasses.replace(jm.packed, words=np.asarray(jm.packed.words)[:T],
                                  leaf_ref=np.asarray(jm.packed.leaf_ref)[:T])
    js, jt, _ = jax_ee(jpacked, X, bound, policy.slack(3), guard=policy.guard)
    np.testing.assert_array_equal(
        jee.predict_label_from_scores(got.numpy(), "multiclass"),
        jee.predict_label_from_scores(np.asarray(js), "multiclass"))
    assert isinstance(adapter._trees_dev, torch.Tensor)
    assert adapter.mean_trees_evaluated() == np.asarray(jt).mean()


def test_engine_reports_mean_trees_evaluated(models):
    jm, pm, X = models["binary"]
    policy = EarlyExitPolicy(epsilon=0.0)
    with GBDTEngine(pm, backend="reference", max_batch=8, max_wait_ms=1.0,
                    early_exit=policy) as engine:
        futs = [engine.submit(X[i]) for i in range(40)]
        got = np.stack([f.result(timeout=60) for f in futs])
    s = engine.stats()
    want = jee.predict_early_exit(jm.forest, X[:40], JaxPolicy(epsilon=0.0), check_every=8)
    np.testing.assert_array_equal(jee.predict_label_from_scores(got, "binary"),
                                  jee.predict_label_from_scores(want.scores, "binary"))
    # warm-up rows were reset; padded bucket rows count like real ones
    assert s.n_requests == 40 and s.n_early_exit_rows >= 40
    assert 0 < s.mean_trees_evaluated < int(pm.forest.n_trees)
    plain = GBDTEngine(pm, backend="reference").stats()
    assert plain.mean_trees_evaluated == 0.0 and plain.n_early_exit_rows == 0


# ----------------------------------------------- the .toad early_exit section
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_policy_round_trips_between_the_packages(models, tmp_path, task):
    jm, _, X = models[task]
    kw = {"epsilon": 0.25, "min_trees": 3, "per_class_epsilon": None
          if task == "binary" else (0.0, float("inf"), 0.5)}
    jm.early_exit_policy = JaxPolicy(**kw)
    try:
        jpath = jm.save(str(tmp_path / "jax.toad"))
    finally:
        jm.early_exit_policy = None
    port = ToadModel.load(jpath, device="cpu")
    assert port.early_exit_policy == EarlyExitPolicy(**kw)
    ppath = port.save(str(tmp_path / "port.toad"))
    loaded = jax_load_checked(ppath)  # toadcheck, TOAD120/TOAD121 included
    assert not [d for d in loaded.diagnostics if d.severity == "error"]
    assert loaded.model.early_exit_policy == JaxPolicy(**kw)
    with np.load(jpath) as a, np.load(ppath) as b:
        ma = json.loads(bytes(a["meta_json"].tobytes()).decode())
        mb = json.loads(bytes(b["meta_json"].tobytes()).decode())
    assert ma["early_exit"] == mb["early_exit"]
    # and a bundle without a policy has no section, in either package
    bare = _port(jm).save(str(tmp_path / "bare.toad"))
    assert ToadModel.load(bare, device="cpu").early_exit_policy is None
    assert jax_load_checked(bare).model.early_exit_policy is None
