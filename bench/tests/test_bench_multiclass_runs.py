"""Whole runs of the multiclass fit cell on the CPU at a small size: a sound
run is correct, and each fault of ``faults_multiclass.py`` planted in the
program's timed path, and the bfloat16 control, come out not correct; the
runner's short warm-up and its window of at least ``min_fits`` fits."""

import json
import subprocess
import sys
import time

import pytest
from bench_small import ROOT

from bench.core import harness, spec
from bench.faults_multiclass import CONTROLS, FAULTS

NAME = "covtype_multi-fit"
#: a seed whose small fit the bfloat16 histograms change (few do at this
#: size; most do at the cell's)
SEED = 7
#: 4 rounds of 7 classes over 2,000 rows; a table of 48 leaf values, full
#: after the first rounds, so that the full table's path runs too; one fit a
#: window, as the limits' readings run it
SMALL = {"config": {"rows": 2000, "gbdt": {"n_rounds": 4, "leaf_capacity": 48},
                    "inputs": {"edge_sample_rows": 2000}},
         "traffic": {"min_fits": 1}}
RUNNER = "fit_sweep_multiclass"


def _run(seed=SEED, trace=False):
    return harness.run_cell(NAME, seed, 0.0, trace, "cpu", time.perf_counter(), SMALL)


def test_sound_run_is_correct():
    result, checks = _run()
    assert result["correct"], checks
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "train_round_ms"}
    assert {k for k, _, _ in checks} >= {"split_regret", "leaf_gap", "table_regret",
                                         "tree_faults"}


@pytest.mark.parametrize("fault", sorted(FAULTS[RUNNER]))
def test_fault_is_not_correct(fault):
    with FAULTS[RUNNER][fault]():
        result, checks = _run()
    assert not result["correct"], checks


def test_control_is_not_correct():
    with CONTROLS[RUNNER]():
        result, checks = _run()
    assert not result["correct"], checks


def test_traced_run_on_the_cpu_reports_no_device_metric():
    result, _ = _run(trace=True)
    assert set(result["metrics"]) <= {"train_host_queue_ms"}
    assert result["device"]["platform"] == "cpu"


def test_warmup_is_short_and_a_window_runs_min_fits():
    from repro_torch import tracing

    from bench.core import fit_sweep_multiclass as runner

    cell = spec.cell(NAME, {**SMALL, "traffic": {"min_fits": 3, "warmup_rounds": 2}})
    tracing.clear()
    with tracing.collect() as spans:
        state = runner.setup(cell, SEED, "cpu")
    assert [s.name for s in spans].count("train.round") == 2  # the warm-up's rounds
    assert state["base"].n_rounds == 4
    with tracing.collect() as spans:
        done = runner.window(state, 0.0)
    assert done["attempted"] == 3 and done["rounds"] == 4
    assert [f["pen"] for f in done["fits"]] == state["order"][:3]
    rounds = [s for s in spans if s.name == "train.round"]
    assert len(rounds) == 3 * 4 and all(s.counts == {"classes": 7} for s in rounds)
    assert all(int(f["forest"].n_trees) == 4 * 7 for f in done["fits"])
    tracing.clear()


def test_faults_script_reads_both_sides():
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "faults_multiclass.py"), "--seeds", str(SEED),
         "--control-seeds", str(SEED), "--faults", "second_nearest", "--fault-seeds", str(SEED),
         "--device", "cpu", "--overrides", json.dumps(SMALL)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [r["side"] for r in lines[:-1]] == ["program", "control", "fault:second_nearest"]
    assert [r["correct"] for r in lines[:-1]] == [True, False, False]
    table = lines[-1]["summary"]["table_regret"]
    assert table["program"] <= table["limit"] < table["fault:second_nearest"]
