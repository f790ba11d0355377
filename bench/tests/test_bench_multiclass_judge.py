"""The multiclass judge (``reference.trainer_multiclass``) on hand-worked
3-class fits of depth 1 over 9 rows: a round's used sets carry from class
to class, a class tree may stay unsplit inside a taken round, a full leaf
table is read by ``table_regret``, and a split at ``min_child_weight``'s
float32 rounding is a weight tie."""

import json

import numpy as np
import pytest
import torch
from bench_small import ROOT

from bench.reference import trainer_multiclass as judge

C = 3
CFG = dict(max_depth=1, reg_lambda=1.0, gamma=0.0, min_child_weight=1e-3,
           min_child_samples=1, learning_rate=0.1)
BINS = torch.tensor([[0, 0], [0, 1], [1, 2], [1, 3], [2, 0], [2, 1], [3, 2], [3, 3], [3, 0]],
                    dtype=torch.uint8)
EDGES = torch.tensor([[0.5, 1.5, 2.5], [0.5, 1.5, 2.5]])
#: every class present; at the base scores the unpenalised root gains are
#: class 0: (0, 1) 1.5416, class 1: (0, 2) 0.7255, (0, 1) 0.3106,
#: class 2: (0, 1) 0.5959 (feature, edge)
Y3 = torch.tensor([0, 0, 0, 0, 2, 2, 2, 1, 1], dtype=torch.float32)
#: no row of class 1: its gradient is the same on every row, so no split of
#: its tree has a positive gain
Y2 = torch.tensor([0, 0, 0, 0, 2, 2, 2, 2, 2], dtype=torch.float32)
TABLE_LIMIT = json.loads(
    (ROOT / "bench/traffic/fit_penalty_sweep_multiclass.json").read_text())["checks"][
        "table_regret"]


def _gh(y):
    """float64 (g, h) of every class at the base scores, (C, n) each."""
    onehot = torch.nn.functional.one_hot(y.long(), C).double()
    base = torch.log((onehot.sum(0) / len(y)).clamp(1e-6, 1.0))
    p = torch.softmax(base[None].expand(len(y), C), 1)
    return (p - onehot).T, (2 * p * (1 - p)).T, base


def _leaf_values(y, splits):
    """(C, 2) float64 values ``−lr·G/(H+λ)`` of each class tree's leaves;
    ``splits[c]``: (feature, edge), or None for an unsplit tree (every row
    left)."""
    g, h, _ = _gh(y)
    out = np.zeros((C, 2))
    for c, s in enumerate(splits):
        left = torch.ones(len(y), dtype=torch.bool) if s is None else BINS[:, s[0]].long() <= s[1]
        for j, rows in enumerate((left, ~left)):
            if rows.any():
                out[c, j] = -0.1 * float(g[c][rows].sum()) / (float(h[c][rows].sum()) + 1.0)
    return out


def _fit(y, splits, leaf_ref, table, accepted=True):
    """One round of 3 depth-1 trees; ``table`` is the leaf table at its
    capacity (its length)."""
    split = [s is not None for s in splits]
    return {"feature": np.array([[s[0] if s else 0] for s in splits]),
            "thr_bin": np.array([[s[1] if s else 0] for s in splits]),
            "is_split": np.array([[b] for b in split]),
            "leaf_ref": np.array(leaf_ref),
            "leaf_values": np.asarray(table, np.float32),
            "n_leaf_values": np.asarray(len(table)), "n_trees": np.asarray(C if accepted else 0),
            "base_score": _gh(y)[2].numpy().astype(np.float32), "accepted": np.array([accepted])}


def _check(y, fit, pen=(0.0, 0.0), **cfg):
    return judge.check_fit(BINS, y, EDGES, dict(CFG, **cfg), pen[0], pen[1], fit, n_classes=C,
                           rounds=1, chunk_rows=4)


def test_unsplit_class_tree_in_a_taken_round_is_no_fault():
    splits = [(0, 1), None, (0, 1)]
    got = _check(Y2, _fit(Y2, splits, [[0, 1], [2, 0], [3, 4]], [0.1, -0.1, 0.0, 0.2, -0.2]))
    assert got["tree_faults"] == 0 and got["empty_class_trees"] == 1
    assert got["split_regret"] == 0.0


def test_taken_round_with_no_split_is_one_fault():
    got = _check(Y2, _fit(Y2, [None] * C, [[0, 0], [1, 0], [2, 0]], [0.1, 0.0, -0.1]))
    assert got["faults_empty_round"] == 1 and got["tree_faults"] == 1
    assert got["empty_class_trees"] == C
    assert got["split_regret"] > 0.5  # and the best splits were left


def test_split_paid_for_by_an_earlier_class_reads_no_regret():
    # iota + xi = 1.1 lies between class 2's gain (0.596) and class 0's
    # (1.542): class 2's split on (0, 1) is positive only because class 0
    # paid for feature 0 and its threshold 1 earlier in the round
    pen = (0.9, 0.2)
    splits = [(0, 1), (0, 2), (0, 1)]
    values = _leaf_values(Y3, splits)
    fit = _fit(Y3, splits, [[0, 1], [2, 3], [4, 5]], values.reshape(-1))
    got = _check(Y3, fit, pen)
    assert got["split_regret"] == 0.0 and got["tree_faults"] == 0
    assert got["leaf_gap"] < 1e-6
    # the same split with nothing paid before it costs 1.1 and falls short
    fit = _fit(Y3, [None, None, (0, 1)], [[0, 0], [1, 0], [2, 3]], [0.0, 0.0, 0.1, -0.1])
    assert _check(Y3, fit, pen)["split_regret"] > 0.5


def _nearest(table, v):
    order = np.argsort(np.abs(np.asarray(table, np.float32).astype(np.float64) - v), kind="stable")
    return order[0], order[1]


def test_full_table_reads_table_regret():
    # a table of 2 values, filled by class 0's two leaves; classes 1 and 2
    # then take stored values
    splits = [(0, 1), (0, 2), (0, 1)]
    values = _leaf_values(Y3, splits)
    table = values[0]
    near = [[int(_nearest(table, v)[0]) for v in values[c]] for c in (1, 2)]
    got = _check(Y3, _fit(Y3, splits, [[0, 1], *near], table))
    assert got["table_regret"] == 0.0 and got["tree_faults"] == 0
    assert got["table_full_round"] == 0 and got["leaf_gap"] < 1e-6
    second = [[int(_nearest(table, v)[1]) for v in values[c]] for c in (1, 2)]
    got = _check(Y3, _fit(Y3, splits, [[0, 1], *second], table))
    assert got["table_regret"] > TABLE_LIMIT and got["tree_faults"] == 0


def test_a_split_at_the_weight_limits_rounding_is_a_weight_tie():
    # class 0 splits on (0, 0): its left side holds rows 0-1, hessian 0.98765...
    _, h, _ = _gh(Y3)
    h_left = float(h[0][BINS[:, 0] == 0].sum())
    one_step_above = float(np.nextafter(np.float32(h_left), np.float32(np.inf)))
    splits = [(0, 0), None, None]
    fit = _fit(Y3, splits, [[0, 1], [2, 0], [3, 0]], [0.1, -0.1, 0.0, 0.05])
    got = _check(Y3, fit, min_child_weight=one_step_above)
    assert got["weight_ties"] == 1 and got["faults_invalid"] == 0 and got["tree_faults"] == 0
    got = _check(Y3, fit, min_child_weight=2 * h_left)  # well above the side's hessian
    assert got["faults_invalid"] == 1 and got["tree_faults"] == 1 and got["weight_ties"] == 0


@pytest.mark.parametrize("kind", ["dead", "past_table"])
def test_other_faults_are_counted_by_kind(kind):
    splits = [(0, 1), None, (0, 1)]
    fit = _fit(Y2, splits, [[0, 1], [2, 0], [3, 4]], [0.1, -0.1, 0.0, 0.2, -0.2])
    if kind == "dead":  # depth 2: class 1's unsplit root leaves node 2 dead; it splits
        fit["feature"] = np.zeros((C, 3), np.int64)
        fit["thr_bin"] = np.ones((C, 3), np.int64)
        fit["is_split"] = np.array([[True, False, False], [False, False, True],
                                    [True, False, False]])
        fit["leaf_ref"] = np.array([[0, 0, 1, 0], [2, 0, 0, 0], [3, 0, 4, 0]])
        got = judge.check_fit(BINS, Y2, EDGES, dict(CFG, max_depth=2), 0.0, 0.0, fit,
                              n_classes=C, rounds=1)
        assert got["faults_dead"] == 1
    else:
        fit["leaf_ref"][2, 1] = 9
        got = _check(Y2, fit)
        assert got["faults_ref"] >= 1
    assert got["tree_faults"] >= 1


def test_gain_error_bounds_the_programs_float32_gains():
    # a root late in a fit: 200,000 rows whose gradients cancel overall but
    # not bin by bin (a class's rows in the low bins, the rest high), so the
    # running sums over bins are ~1e4 while the total is ~1e2
    from repro_torch.gbdt.trainer import block_cumsum, block_sum

    gen = torch.Generator().manual_seed(3)
    n, d, B, lam = 200_000, 4, 64, 1.0
    p = torch.rand(n, generator=gen, dtype=torch.float64)
    y = (torch.rand(n, generator=gen, dtype=torch.float64) < p).double()
    g, h = p - y, 2 * p * (1 - p)
    key = -g + 0.3 * torch.randn((d, n), generator=gen, dtype=torch.float64)
    bins = (key.argsort(1).argsort(1) * B // n).T  # (n, d): quantile bins of -g, blurred
    hist = torch.zeros((d, B, 2), dtype=torch.float64)
    for f in range(d):
        hist[f].index_add_(0, bins[:, f], torch.stack([g, h], 1))
    E = B - 1
    cum, tot = hist.cumsum(1)[None, :, :E], hist[0].sum(0)[None]  # one node
    GL, HL = cum[..., 0], cum[..., 1]
    GR, HR = tot[:, None, None, 0] - GL, tot[:, None, None, 1] - HL
    children = 0.5 * (GL**2 / (HL + lam) + GR**2 / (HR + lam))
    parent_term = 0.5 * (tot[:, 0]**2 / (tot[:, 1] + lam))[:, None, None]
    err = judge.gain_error(GL, HL, GR, HR, tot, children, parent_term, lam,
                           float((g.abs() + p).sum()), float(h.sum()),
                           torch.maximum(GL.abs().amax(-1), tot[:, None, 0].abs()), 1)
    # the program: each cell rounded once to float32, its block sums, its gain
    h32 = hist.float()[None].movedim(-2, -1)  # (1, d, 2, B)
    left = block_cumsum(h32)[..., :E]
    t32 = block_sum(h32[:, 0])
    gl, hl = left[:, :, 0], left[:, :, 1]
    gr, hr = t32[:, None, None, 0] - gl, t32[:, None, None, 1] - hl
    gain32 = 0.5 * (gl**2 / (hl + lam) + gr**2 / (hr + lam)
                    - (t32[:, 0]**2 / (t32[:, 1] + lam))[:, None, None])
    miss = (gain32.double() - (children - parent_term)).abs()
    assert float(cum[..., 0].abs().max()) > 50 * float(tot[0, 0].abs())  # it cancels
    assert bool((miss <= err).all()) and float(miss.max()) > 0
    # and the bound stays small: 3.3e-5 of the largest children score here,
    # against 5.9e-4 and more that the bfloat16 control falls short at the
    # cell's size
    assert float(err.max()) < 5e-5 * float(children.max())
