"""The port's multiclass fit judged on the CPU: Covertype's rows at a small
size (4,000 rows, 6 rounds of 7 classes, the configuration's 64 bins,
depth 3 and leaf table), one case for each penalty pair of the sweep; one
fit each, judged by ``reference.trainer_multiclass`` through the runner.

The CPU's plain histograms sum in float32 row by row, not in the card's
int64 fixed point, so these bounds hold the CPU's own readings and are not
the cell's limits (``PERF.md`` §6 gives the card's)."""

import dataclasses

import pytest
import torch

from bench.core import fit_sweep_multiclass as runner
from bench.core import spec
from bench.inputs import covtype
from bench.reference.binning import bin_rows, fit_bins

NAME = "covtype_multi-fit"
SEED = 2**31 + 4545
SMALL = {"config": {"rows": 4000, "gbdt": {"n_rounds": 6}}}
#: the largest readings over the five pairs at this seed on the CPU were
#: split_regret 0 and leaf_gap 5.5e-5 (float32 leaf sums of 4,000 rows
#: against float64); the bounds leave room for another CPU's summation order
SPLIT_REGRET = 1e-6
LEAF_GAP = 2e-4


@pytest.fixture(scope="module")
def table():
    cell = spec.cell(NAME, SMALL)
    cfg = cell["config"]
    x, y = covtype.draw(SEED, 0, cfg["rows"], cfg["n_features"], "cpu", labels=True)
    edges = torch.from_numpy(fit_bins(x[:2048].numpy(), cfg["n_bins"]))
    return cell, bin_rows(x, edges), y, edges


@pytest.mark.parametrize("pen", spec.cell(NAME)["traffic"]["penalties"], ids=str)
def test_multiclass_fit_reads_no_fault(table, pen):
    from repro_torch.api import ToadModel
    from repro_torch.gbdt.trainer import GBDTConfig

    cell, bins, y, edges = table
    cfg = dataclasses.replace(GBDTConfig(**cell["config"]["gbdt"]),
                              toad_penalty_feature=pen[0], toad_penalty_threshold=pen[1])
    model = ToadModel(config=cfg, n_bins=cell["config"]["n_bins"], device="cpu").fit_binned(
        bins, y, edges)
    fit = dict(pen=pen, forest=model.forest, accepted=model.history["accepted"])
    got = runner.judge([fit], bins, y, edges, cell)
    assert got["tree_faults"] == 0 and got["weight_ties"] == 0
    assert got["split_regret"] <= SPLIT_REGRET and got["leaf_gap"] <= LEAF_GAP, got
    assert got["table_regret"] == 0.0  # 6 rounds leave the table of 4,096 with room
