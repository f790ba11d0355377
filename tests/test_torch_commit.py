"""The trainer's per-level split commit (``kernels/commit.py``) on the CPU.

The plain version's contract: the nodes of a level commit in order, so a
later node pays no ι (or ξ) for a feature (or threshold) an earlier node
of the level paid for; ties go to the first maximal index; a NaN gain wins
the maximum and commits nothing; a dead node never splits; ``n_splits``
counts the commits.  The wrapper runs the plain version on the CPU (and on
the meta device) without a launch, and refuses a wrong dtype, shape,
device or layout on every device.  The kernel is held to the plain version
on the card in ``tests/test_torch_cuda.py``.
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import COMMIT_CASES, bits_equal, commit_inputs, run_commit  # noqa: E402
from repro_torch.kernels.commit import commit_level, commit_level_ref  # noqa: E402


def level(gain, *, pen=(0.0, 0.0), dead=None, valid=None):
    """A level of ``len(gain)`` nodes (nodes n-1 .. 2n-2 of a tree of
    2n-1), nothing used yet, every candidate valid unless ``valid`` says."""
    gain = torch.tensor(gain, dtype=torch.float32)
    n_nodes, d, E = gain.shape
    I = 2 * n_nodes - 1
    ins = (gain,
           torch.ones(gain.shape, dtype=torch.bool) if valid is None else torch.tensor(valid),
           torch.full((n_nodes,), 50.0),
           torch.zeros(n_nodes, dtype=torch.bool) if dead is None else torch.tensor(dead),
           torch.tensor(pen[0]), torch.tensor(pen[1]))
    outs = dict(used_feat=torch.zeros(d, dtype=torch.bool),
                used_thr=torch.zeros((d, E), dtype=torch.bool),
                t_feat=torch.zeros(I, dtype=torch.int32), t_thr=torch.zeros(I, dtype=torch.int32),
                t_split=torch.zeros(I, dtype=torch.bool), t_gain=torch.zeros(I),
                n_splits=torch.tensor(5, dtype=torch.int32))
    return ins, dict(cegb=0.0, n_rows=100, base_idx=n_nodes - 1), outs


def committed(gain, **kw):
    ins, scalars, outs = level(gain, **kw)
    return run_commit(commit_level_ref, ins, scalars, outs)


def test_a_later_node_pays_no_iota_for_a_feature_an_earlier_node_paid_for():
    # node 0 pays ι = 8 for feature 1 (10 - 8 > 0); node 1's feature 0 has
    # the larger raw gain, but only feature 1 is free now
    got = committed([[[0.0, 0.0], [10.0, 0.0]], [[5.0, 0.0], [1.0, 0.0]]], pen=(8.0, 0.0))
    assert got["t_split"][1:].tolist() == [True, True]
    assert got["t_feat"][1:].tolist() == [1, 1] and got["t_thr"][1:].tolist() == [0, 0]
    assert got["t_gain"][1:].tolist() == [10.0, 1.0]  # the raw gains, not the penalised
    assert got["used_feat"].tolist() == [False, True]
    # alone, node 1 pays ι for either feature and does not split
    alone = committed([[[5.0, 0.0], [1.0, 0.0]]], pen=(8.0, 0.0))
    assert not alone["t_split"].any() and int(alone["n_splits"]) == 5


def test_a_later_node_pays_no_xi_for_a_threshold_an_earlier_node_paid_for():
    got = committed([[[0.0, 5.0]], [[3.0, 1.0]]], pen=(0.0, 4.0))
    assert got["t_thr"][1:].tolist() == [1, 1]
    assert got["used_thr"].tolist() == [[False, True]]


@pytest.mark.parametrize("gain,want", [
    ([[[3.0, 3.0], [0.0, 3.0]]], (0, 0)),   # within a row
    ([[[1.0, 3.0], [3.0, 2.0]]], (0, 1)),   # across features
    ([[[0.0, 1.0], [1.0, 1.0]]], (0, 1)),   # three-way
], ids=["within-a-row", "across-features", "three-way"])
def test_ties_take_the_first_maximal_index(gain, want):
    got = committed(gain)
    assert (int(got["t_feat"][0]), int(got["t_thr"][0])) == want


def test_a_nan_gain_wins_the_maximum_and_commits_nothing():
    gain = [[[9.0, float("nan")]], [[9.0, float("nan")]]]
    # node 0's NaN is valid; node 1's is not, so its 9 commits
    got = committed(gain, valid=[[[True, True]], [[True, False]]])
    assert got["t_split"][1:].tolist() == [False, True]
    assert int(got["n_splits"]) == 6


def test_a_dead_node_never_splits():
    got = committed([[[100.0, 1.0]], [[1.0, 100.0]]], dead=[True, False])
    assert got["t_split"][1:].tolist() == [False, True]
    assert got["used_thr"].tolist() == [[False, True]]
    assert int(got["n_splits"]) == 6


def test_n_splits_counts_the_commits():
    gain = [[[2.0, -1.0]], [[-3.0, -1.0]], [[0.0, 4.0]], [[0.0, 0.0]]]
    got = committed(gain)
    assert got["t_split"][3:].tolist() == [True, False, True, False]
    assert int(got["n_splits"]) == 5 + 2


@pytest.mark.parametrize("case", ["54x63", "ties-everywhere", "dead-nodes", "nan-gains",
                                  "cegb", "half-used"])
def test_the_wrapper_runs_the_plain_version_on_the_cpu_without_a_launch(case):
    ins, scalars, outs = commit_inputs("cpu", **COMMIT_CASES[case])
    want = run_commit(commit_level_ref, ins, scalars, outs)
    before = commit_level.launches
    got = run_commit(commit_level, ins, scalars, outs)
    assert commit_level.launches == before == 0
    for k in outs:
        assert bits_equal(got[k], want[k]), k
    assert int(want["n_splits"]) > int(outs["n_splits"])


def test_the_meta_device_runs_the_plain_version():
    """The dry run traces the trainer on the meta device: shapes only."""
    ins, scalars, outs = commit_inputs("cpu", 4, 8, 15)
    meta = lambda t: torch.empty_like(t, device="meta")
    commit_level(*map(meta, ins), **scalars, **{k: meta(v) for k, v in outs.items()})
    assert commit_level.launches == 0


def _bad(ins, scalars, outs, what):
    ins = list(ins)
    if what == "gain float64":
        ins[0] = ins[0].double()
    elif what == "valid uint8":
        ins[1] = ins[1].to(torch.uint8)
    elif what == "totC (n+1,)":
        ins[2] = torch.cat([ins[2], ins[2][:1]])
    elif what == "pen_f (1,)":
        ins[4] = ins[4].reshape(1)
    elif what == "used_thr (d, E+1)":
        outs["used_thr"] = torch.zeros(outs["used_thr"].shape[0],
                                       outs["used_thr"].shape[1] + 1, dtype=torch.bool)
    elif what == "used_thr not contiguous":
        outs["used_thr"] = outs["used_thr"].t().contiguous().t()
    elif what == "t_feat int64":
        outs["t_feat"] = outs["t_feat"].long()
    elif what == "n_splits (1,)":
        outs["n_splits"] = outs["n_splits"].reshape(1)
    elif what == "used_feat on another device":
        outs["used_feat"] = torch.empty_like(outs["used_feat"], device="meta")
    elif what == "a list for dead":
        ins[3] = ins[3].tolist()
    elif what == "base_idx past the tree":
        scalars = dict(scalars, base_idx=scalars["base_idx"] + 1)
    elif what == "no candidate":
        ins[0], ins[1] = ins[0][:, :, :0], ins[1][:, :, :0]
        outs["used_thr"] = outs["used_thr"][:, :0]
    return ins, scalars, outs


@pytest.mark.parametrize("what", [
    "gain float64", "valid uint8", "totC (n+1,)", "pen_f (1,)", "used_thr (d, E+1)",
    "used_thr not contiguous", "t_feat int64", "n_splits (1,)", "used_feat on another device",
    "a list for dead", "base_idx past the tree", "no candidate",
])
def test_the_wrapper_refuses(what):
    """Checked the same way on every device, before any work: nothing is
    written to the outputs."""
    ins, scalars, outs = _bad(*commit_inputs("cpu", 4, 8, 15), what)
    before = {k: v.clone() for k, v in outs.items()}
    with pytest.raises(ValueError, match="commit_level"):
        commit_level(*ins, **scalars, **outs)
    for k, v in outs.items():
        if v.device.type == "cpu" and v.shape == before[k].shape:
            assert torch.equal(v, before[k]), k
