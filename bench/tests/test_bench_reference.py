"""The plain reference on hand-worked cases: the forest walk, the binning,
and the node-by-node judge of a fit."""

import math

import numpy as np
import pytest
import torch

from bench.reference import binning, forest, forestgen, trainer


def _stump_forest():
    """Two depth-2 trees over 2 features, 2 classes: tree 0 (class 0)
    splits x0 <= 0.5 then, on the left, x1 <= -1; tree 1 (class 1) splits
    only at the root, x1 <= 0."""
    return {
        "feature": np.array([[0, 1, 0], [1, 0, 0]], np.int32),
        "thr_bin": np.array([[1, 0, 0], [1, 0, 0]], np.int32),
        "is_split": np.array([[True, True, False], [True, False, False]]),
        "leaf_ref": np.array([[0, 1, 2, 3], [4, 4, 5, 5]], np.int32),
        "leaf_values": np.array([1.0, 2.0, 3.0, 4.0, 10.0, 20.0], np.float32),
        "n_leaf_values": np.asarray(6, np.int32),
        "n_trees": np.asarray(2, np.int32),
        "edges": np.array([[-1.0, 0.5, 2.0], [-1.0, 0.0, 3.0]], np.float32),
        "base_score": np.array([0.5, -0.5], np.float32),
    }


def test_walk_by_hand():
    x = torch.tensor([[0.0, -2.0], [0.0, 0.0], [1.0, 5.0], [0.5, -1.0]])
    # row 0: x0 <= .5 left, x1 <= -1 left -> leaf 0 (1.0); x1 <= 0 -> 10
    # row 1: left, x1 > -1 -> leaf 1 (2.0); x1 <= 0 -> 10
    # row 2: x0 > .5 -> node 2, unsplit -> leaf 2 (3.0); x1 > 0 -> 20
    # row 3: x0 <= .5 (equal goes left), x1 <= -1 -> leaf 0; -> 10
    want = torch.tensor([[1.5, 9.5], [2.5, 9.5], [3.5, 19.5], [1.5, 9.5]], dtype=torch.float64)
    got = forest.score(x, _stump_forest(), 2, chunk_rows=3)
    assert got.dtype == torch.float64 and torch.equal(got, want)


def test_control_is_coarser():
    rng = np.random.default_rng(0)
    arrays = forestgen.synthetic_forest(3, n_trees=64, max_depth=6, n_features=32, n_bins=64,
                                        n_used_features=16)
    x = torch.from_numpy(rng.standard_normal((4096, 32)).astype(np.float32))
    exact = forest.score(x, arrays, 1)
    low = forest.score_low(x, arrays, 1)
    gap = float((low.double() - exact).abs().max())
    assert gap > 1e-3  # far past float32 rounding (~1e-6 at this size)


def test_forestgen_on_given_edges():
    edges = np.full((5, 7), np.inf, np.float32)
    edges[:, 0] = 0.0
    edges[2, :3] = [0.0, 1.0, 2.0]
    a = forestgen.synthetic_forest(1, n_trees=20, max_depth=3, n_features=5, n_bins=8,
                                   n_used_features=3, edges=edges)
    split = a["is_split"]
    thr = a["thr_bin"][split]
    assert np.isfinite(edges[a["feature"][split], thr]).all()
    assert a["edges"] is not None and a["leaf_ref"].shape == (20, 8)


def test_bins_are_the_definition():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((300, 6), generator=g)
    edges = torch.sort(torch.randn((6, 15), generator=g), 1).values
    edges[4, 9:] = math.inf
    x[0, 1] = edges[1, 3]  # a row on an edge: that edge is not below it
    want = (x[:, :, None] > edges[None]).sum(-1)
    assert torch.equal(binning.bin_rows(x, edges, chunk_rows=64).long(), want)


def test_fit_bins_copy_matches_program():
    from repro_torch.gbdt.binning import fit_bins

    x = np.random.default_rng(1).standard_normal((2000, 20)).astype(np.float32)
    x[:, 3] = np.round(x[:, 3])  # few distinct values: duplicated quantiles
    assert np.array_equal(binning.fit_bins(x, 32), fit_bins(x, 32))


# ---- the judge of a fit ------------------------------------------------------

CFG = dict(max_depth=1, reg_lambda=1.0, gamma=0.0, min_child_weight=1e-3,
           min_child_samples=1, learning_rate=0.1)


def _toy():
    """8 rows, 2 features of 4 bins; the labels follow feature 0 exactly
    (bin <= 1 -> 0), feature 1 is noise."""
    bins = torch.tensor([[0, 3], [1, 0], [0, 2], [1, 1], [2, 0], [3, 3], [2, 1], [3, 2]],
                        dtype=torch.uint8)
    y = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1], dtype=torch.float32)
    edges = torch.tensor([[0.5, 1.5, 2.5], [0.5, 1.5, 2.5]])
    return bins, y, edges


def _fit(feature, thr, split, values, ref=(0, 1)):
    return {"feature": np.array([[feature]]), "thr_bin": np.array([[thr]]),
            "is_split": np.array([[split]]), "leaf_ref": np.array([list(ref)]),
            "leaf_values": np.array(values, np.float32), "n_leaf_values": np.asarray(len(values)),
            "n_trees": np.asarray(1), "base_score": np.array([0.0], np.float32),
            "accepted": np.array([True])}


def _leaves(left_rows):
    """By hand: p = 0.5 at the base (4 of 8 positive), g = p - y, h = 1/4;
    a leaf of k negative rows: G = k/2, H = k/4 -> -0.1 * G / (H + 1)."""
    return [-0.1 * (k / 2) / (k / 4 + 1) for k in left_rows]


def test_judge_best_split_reads_zero():
    bins, y, edges = _toy()
    fit = _fit(0, 1, True, [_leaves([4])[0], 0.1 * 2 / 2])
    got = trainer.check_fit(bins, y, edges, CFG, 0.0, 0.0, fit, rounds=1, chunk_rows=3)
    assert got["split_regret"] == 0.0 and got["tree_faults"] == 0
    assert got["leaf_gap"] < 1e-6


def test_judge_worse_split_and_wrong_leaf():
    bins, y, edges = _toy()
    # feature 0, edge 0 separates 2 of the 4 negatives: worse than edge 1
    fit = _fit(0, 0, True, [-1.0, 1.0])
    got = trainer.check_fit(bins, y, edges, CFG, 0.0, 0.0, fit, rounds=1)
    # best: G_L = 2, G_R = -2, H = 1 each side -> children 0.5 * (4/2 + 4/2) = 2
    # edge 0: rows {0, 2}: G_L = 1, H_L = .5; G_R = -1, H_R = 1.5 ->
    # 0.5 * (1/1.5 + 1/2.5) = 0.5333; regret (2 - .5333) / 2
    assert got["split_regret"] == pytest.approx((2 - 0.5 * (1 / 1.5 + 1 / 2.5)) / 2)
    assert got["leaf_gap"] > 1


def test_judge_penalties_and_unsplit():
    bins, y, edges = _toy()
    # with iota = 10 the best penalised gain (2 - 10 - xi) is negative: no split is right
    fit = _fit(0, 0, False, [0.0])
    fit["leaf_ref"] = np.array([[0, 0]])
    got = trainer.check_fit(bins, y, edges, CFG, 10.0, 1.0, fit, rounds=1)
    assert got["split_regret"] == 0.0
    # without the penalty, leaving the node unsplit falls short by the whole gain
    got = trainer.check_fit(bins, y, edges, CFG, 0.0, 0.0, fit, rounds=1)
    assert got["split_regret"] == pytest.approx(1.0)  # gain 2 over children 2
    assert got["tree_faults"] == 1  # and a round with no split was taken in


def test_judge_counts_faults():
    bins, y, edges = _toy()
    fit = _fit(0, 1, True, [0.0, 0.0], ref=(0, 7))  # a leaf past the table
    assert trainer.check_fit(bins, y, edges, CFG, 0.0, 0.0, fit, rounds=1)["tree_faults"] == 1
    fit = _fit(5, 1, True, [0.0, 0.0])  # a feature that does not exist
    assert trainer.check_fit(bins, y, edges, CFG, 0.0, 0.0, fit, rounds=1)["tree_faults"] == 1
