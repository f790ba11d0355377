"""Whole runs of the harness on the CPU at small sizes: a sound run is
correct, and each fault that a cell can have, planted in the program's
timed path, and the lower-precision control come out not correct."""

import json
import subprocess
import sys
import time

import pytest
from bench_small import CELLS, FIT, ROOT

from bench.core import harness
from bench.faults import CONTROLS, FAULTS

SEED = 2**31 + 4242


def _run(name, trace=False):
    return harness.run_cell(name, SEED, 0.3, trace, "cpu", time.perf_counter(), CELLS[name])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    result, checks = _run(name)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(CELLS)
                                        for f in FAULTS[
                                            "fit_sweep" if n.endswith("fit") else "score_loop"]])
def test_fault_is_not_correct(name, fault):
    runner = "fit_sweep" if name.endswith("fit") else "score_loop"
    with FAULTS[runner][fault]():
        result, checks = _run(name)
    assert not result["correct"], checks


def test_traced_run_on_the_cpu_reports_no_device_metric():
    result, _ = _run("toad_gbdt-fit", trace=True)
    assert set(result["metrics"]) <= {"train_host_queue_ms"}
    assert result["device"]["platform"] == "cpu"


#: a seed whose first small fit the bfloat16 histograms change (most seeds
#: do at the cell's size, few at this one)
FIT_CONTROL_SEED = 2


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_is_not_correct(name):
    runner = "fit_sweep" if name.endswith("fit") else "score_loop"
    seed, seconds = (FIT_CONTROL_SEED, 0.0) if runner == "fit_sweep" else (SEED, 0.3)
    with CONTROLS[runner]():
        result, checks = harness.run_cell(name, seed, seconds, False, "cpu",
                                          time.perf_counter(), CELLS[name])
    assert not result["correct"], checks


def test_control_script_reads_both_sides():
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "control.py"), "--workload", "toad_gbdt-fit",
         "--seeds", f"1,{FIT_CONTROL_SEED}", "--control-seeds", str(FIT_CONTROL_SEED),
         "--faults", "half_batch", "--fault-seeds", "1", "--device", "cpu",
         "--overrides", json.dumps(FIT)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [r["side"] for r in lines[:-1]] == ["program", "program", "control", "fault:half_batch"]
    assert [r["correct"] for r in lines[:-1]] == [True, True, False, False]
    regret = lines[-1]["summary"]["split_regret"]
    assert regret["program"] <= regret["limit"] < regret["control"]


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
                          "toad_gbdt-fit", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
                          "covtype_multi-score", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
