"""The readers of the program's spans (``metrics/train_host_ms.*.py``,
``metrics/score_host_ms.{check,launch}.py``) on the traced stretches of
the cells at small sizes on the CPU.

On the CPU a traced run reports none of them: the plain versions of the
kernels run inside the spans there, so a span's self time is not the
host's alone.  Given the same record as a run on the card gives it (a
device trace with operations in it), the fit's six readers split the
traced fit's host time; the small scoring cells run the ``packed``
backend, which never reaches ``packed_predict``, so its two readers find
nothing.  A program without spans gives every reader nothing to read."""

import math
import sys
import time

import pytest
from bench_small import CELLS

import repro_torch
from bench.core import harness, spec
from repro_torch import tracing

SEED = 2**31 + 5151
FIT_METRICS = [f"train_host_ms.{k}" for k in ("hist", "split", "commit", "route", "leaves",
                                              "round")]
SCORE_METRICS = ["score_host_ms.check", "score_host_ms.launch"]


def _traced(name):
    """``(record, spans)`` of the cell's traced stretch, run as ``run_cell``
    runs it (set-up, window, trace) on an empty store."""
    tracing.clear()
    cell = spec.cell(name, CELLS[name])
    runner = spec.runner(cell["traffic"])
    state = runner.setup(cell, SEED, "cpu")
    rec = runner.trace(state, runner.window(state, 0.3))
    return rec, tracing.recorded()


def _as_on_the_card(rec):
    return dict(rec, trace=dict(rec["trace"], device_ops=1))


@pytest.mark.parametrize("name", ["toad_gbdt-fit", "covtype_multi-score"])
def test_a_traced_cpu_run_reports_no_span_metric(name):
    tracing.clear()
    result, _ = harness.run_cell(name, SEED, 0.3, True, "cpu", time.perf_counter(),
                                 CELLS[name])
    assert result["correct"]
    assert not set(result["metrics"]) & {*FIT_METRICS, *SCORE_METRICS}
    assert tracing.recorded()  # the traced stretch recorded, the readers declined


def test_the_fit_readers_split_the_traced_fit():
    rec, spans = _traced("toad_gbdt-fit")
    got = {m: spec.metric_reader(m)(_as_on_the_card(rec)) for m in FIT_METRICS}
    assert all(v is not None and math.isfinite(v) and v > 0 for v in got.values()), got
    assert sum(got.values()) <= rec["trace_wall_s"] / rec["rounds"] * 1e3
    roots = [s for s in spans if s.name == "train" and s.parent < 0]
    assert len(roots) == 1  # the traced fit's alone: the window records nothing
    root_self = tracing.self_ns(spans)[spans.index(roots[0])]
    assert sum(got.values()) == pytest.approx(
        (roots[0].duration_ns - root_self) / rec["rounds"] * 1e-6)


def test_the_scoring_readers_find_nothing_on_the_packed_backend():
    rec, spans = _traced("toad_gbdt-score")
    assert [s.name for s in spans] == ["predict"] * len(rec["b1_work"])  # one a request
    for m in SCORE_METRICS:
        assert spec.metric_reader(m)(_as_on_the_card(rec)) is None


def test_a_program_without_spans_gives_every_reader_nothing(monkeypatch):
    rec, _ = _traced("toad_gbdt-fit")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing")
    for m in FIT_METRICS + SCORE_METRICS:
        assert spec.metric_reader(m)(_as_on_the_card(rec)) is None
