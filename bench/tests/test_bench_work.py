"""The frozen counting functions on tiny shapes."""

import numpy as np
import pytest
import torch

from bench.reference import forestgen
from bench.work import counts, peaks


def _packed(arrays, n_ensembles=1):
    from repro_torch.api import ToadModel
    from repro_torch.gbdt.forest import forest_from_numpy
    from repro_torch.gbdt.trainer import GBDTConfig

    task = dict(task="multiclass", n_classes=n_ensembles) if n_ensembles > 1 else dict(task="binary")
    forest = forest_from_numpy(arrays, n_ensembles=n_ensembles, device="cpu")
    model = ToadModel.from_forest(forest, config=GBDTConfig(**task), device="cpu").compress()
    return model, model.device_packed()


@pytest.mark.parametrize("C", [1, 3])
def test_needed_work_by_requests_equals_whole(C):
    arrays = forestgen.synthetic_forest(5, n_trees=12 * C, max_depth=4, n_features=10,
                                        n_bins=16, n_ensembles=C, n_used_features=6)
    model, p = _packed(arrays, C)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((700, 10)).astype(np.float32))
    b, o, scores = counts.needed_work(p, x[100:600])
    assert torch.allclose(scores, model.predictor("packed")(x[100:600]), atol=1e-5)
    assert counts.needed_work_requests(p, x, [(100, 500)], chunk_rows=64) == (b, o)
    two = counts.needed_work_requests(p, x, [(0, 300), (300, 400)], chunk_rows=128)
    assert two[1] == counts.needed_work(p, x)[1]


def test_histogram_work_by_sizes():
    bins = torch.zeros((10, 4), dtype=torch.uint8)
    gh = torch.zeros((10, 3))
    pos = torch.tensor([0, 1, -1, 2, 1, 0, 5, 1, -1, 0], dtype=torch.int32)
    b, o = counts.histogram_work(bins, gh, pos, n_nodes=2, n_bins=8, kept_only=True)
    kept = 6
    assert o == kept * 4 * 3
    assert b == kept * (4 + 12) + 10 * 4 + 2 * 4 * 8 * 3 * 4
    assert (b, o) == counts.histogram_work_sizes(10, 4, 1, 3, 2, 8, kept, kept_only=True)


def test_left_rows_by_level():
    # depth 3: leaves hold 1..8 rows; level 1 left child = leaves 0-3,
    # level 2 left children = leaves 0-1 and 4-5
    cnt = torch.arange(1, 9, dtype=torch.float32)
    assert counts.left_rows_by_level(cnt, 3) == [1 + 2 + 3 + 4, 1 + 2 + 5 + 6]


def test_tree_calls_and_round_work():
    calls = counts.tree_histogram_calls(100, 8, 16, 3, [60, 30])
    assert [o for _, o in calls] == [100 * 8 * 3, 60 * 8 * 3, 30 * 8 * 3, 100 * 1 * 3]
    b, o = counts.round_step_work(100, 8, 16, 3, [60, 30])
    assert b > sum(x for x, _ in calls) and o > sum(y for _, y in calls)


def test_least_seconds():
    assert peaks.least_seconds(3.35e12, 1.0) == (1.0, "bytes")
    assert peaks.least_seconds(1.0, 67e12) == (1.0, "ops")


def test_frozen_copies_count_as_the_originals():
    """The yardstick counts as ``chip_smoke.py``'s originals on a small
    model, and draws the same forest."""
    import chip_smoke

    arrays = forestgen.synthetic_forest(9, n_trees=10, max_depth=5, n_features=12, n_bins=32,
                                        n_used_features=5)
    original = chip_smoke.synthetic_forest(9, n_trees=10, max_depth=5, n_features=12,
                                           n_bins=32, n_used_features=5)
    assert all(np.array_equal(arrays[k], original[k]) for k in original)
    _, p = _packed(arrays)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((300, 12)).astype(np.float32))
    trees = torch.randint(0, 11, (300,), generator=torch.Generator().manual_seed(1))
    for t in (None, trees):
        got, want = counts.needed_work(p, x, t), chip_smoke.needed_work(p, x, t)
        assert got[:2] == want[:2] and torch.equal(got[2], want[2])
    bins = torch.randint(0, 32, (50, 6), dtype=torch.uint8)
    pos = torch.randint(-1, 4, (50,), dtype=torch.int32)
    gh = torch.zeros((50, 3))
    for kept_only in (False, True):
        assert (counts.histogram_work(bins, gh, pos, 3, 32, kept_only)
                == chip_smoke.histogram_work(bins, gh, pos, 3, 32, kept_only))
    assert (peaks.HBM_BYTES_PER_S, peaks.FP32_OPS_PER_S) == (chip_smoke.HBM_BYTES_PER_S,
                                                             chip_smoke.FP32_OPS_PER_S)


@pytest.mark.parametrize("name", ["device_idle.train", "device_idle.score"])
def test_idle_share_is_against_the_untraced_wall(name):
    from bench.core import spec

    read = spec.metric_reader(name)
    rec = {"trace": {"busy_s": 0.5, "window_s": 3.0, "device_ops": 10}, "untraced_wall_s": 2.0}
    assert read(rec) == pytest.approx(75.0)
    assert read(dict(rec, untraced_wall_s=None)) is None
    assert read(dict(rec, trace=dict(rec["trace"], busy_s=0.0))) is None  # no device trace


def test_score_mfu_is_over_the_untraced_cycle():
    from bench.core import spec
    from bench.work.peaks import least_seconds

    read = spec.metric_reader("score_mfu")
    work = [(3.35e9, 1e6), (6.7e9, 1e6)]  # bytes bound both: 1 ms and 2 ms at the peaks
    rec = {"trace": {"device_ops": 4}, "b1_work": work, "untraced_wall_s": 0.006}
    assert sum(least_seconds(b, o)[0] for b, o in work) == pytest.approx(0.003)
    assert read(rec) == pytest.approx(50.0)
    assert read(dict(rec, trace={"device_ops": 0})) is None


def test_innermost_running_equals_a_scan():
    from bench.core.trace import innermost_running

    rng = np.random.default_rng(5)
    starts = rng.permutation(4000)[:300].astype(np.float64)  # distinct starts
    iv = np.stack([starts, starts + rng.integers(1, 400, 300)], 1)
    times = np.r_[rng.uniform(-10, 4500, 500), starts[:50]]
    got = innermost_running(iv, times)
    for t, k in zip(times, got):
        inside = np.nonzero((iv[:, 0] <= t) & (iv[:, 1] > t))[0]
        assert k == (inside[np.argmax(iv[inside, 0])] if len(inside) else -1)
    assert list(innermost_running(np.zeros((0, 2)), np.array([1.0]))) == [-1]
