"""The port's span recorder (``repro_torch.tracing``) on the CPU: off it
records nothing and hands out one object; on, a fit records the trainer's
span tree and a request its ``predict`` spans, with the forest, history,
aux and scores bit-identical to a run with the recorder off; and a span
lies on the profiler's clock."""

import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.api import ToadModel
from repro_torch.api.backends import CudaBackend
from repro_torch.gbdt import GBDTConfig, fit_bins, train
from repro_torch.gbdt.binning import apply_bins

DEPTH, ROUNDS = 3, 2
TASKS = {"binary": dict(task="binary"), "multiclass-3": dict(task="multiclass", n_classes=3)}
LEVEL_STEPS = ("train.hist", "train.split", "train.commit", "train.route")


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _data(task):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(800, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.7) if task == "binary" else np.digitize(X[:, 0], [-0.5, 0.5])
    edges = fit_bins(X, 16)
    bins = apply_bins(torch.from_numpy(X), torch.from_numpy(edges))
    return bins, torch.from_numpy(y.astype(np.float32)), torch.from_numpy(edges)


def _fit(task):
    cfg = GBDTConfig(**TASKS[task], n_rounds=ROUNDS, max_depth=DEPTH, learning_rate=0.3,
                     toad_penalty_feature=0.5, toad_penalty_threshold=0.25)
    return train(cfg, *_data(task))


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


def test_off_records_nothing_and_hands_out_one_object():
    first = tracing.span("train")
    tracemalloc.start()
    try:
        for _ in range(1000):
            with tracing.span("train.hist", rows=1, nodes=2) as got:
                assert got is None
            assert tracing.span("predict") is first
        live = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, tracing.__file__)])
    finally:
        tracemalloc.stop()
    assert sum(stat.size for stat in live.statistics("filename")) == 0
    _fit("binary")
    assert tracing.recorded() == [] and tracing.dropped() == 0


@pytest.mark.parametrize("task", sorted(TASKS))
def test_a_fit_records_the_trainer_span_tree(task):
    C = 3 if task == "multiclass-3" else 1
    with tracing.collect() as spans:
        _fit(task)
    assert spans == tracing.recorded()
    roots = [s for s in spans if s.parent < 0]
    assert [r.name for r in roots] == ["train"]
    assert {s.trace for s in spans} == {roots[0].trace}
    rounds = _children(spans, roots[0])
    assert [s.name for s in rounds] == ["train.round"] * ROUNDS
    assert all(r.counts == {"classes": C} for r in rounds)
    trees = [t for r in rounds for t in _children(spans, r)]
    assert [t.name for t in trees] == ["train.tree"] * (ROUNDS * C)
    for tree in trees:
        steps = _children(spans, tree)
        assert [s.name for s in steps] == list(LEVEL_STEPS) * DEPTH + ["train.leaves"]
        for level in range(DEPTH):
            hist, _, commit, _ = steps[4 * level:4 * level + 4]
            assert hist.counts == {"rows": 800, "nodes": 2**level}
            assert commit.counts == {"nodes": 2**level}
        assert steps[-1].counts == {"leaves": 2**DEPTH}
        assert all(not _children(spans, s) for s in steps)
    by_index = {s.index: s for s in spans}
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = by_index[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    own = tracing.self_ns(spans)
    assert all(t >= 0 for t in own)
    assert sum(own) == roots[0].duration_ns  # the self times tile the root


@pytest.mark.parametrize("task", sorted(TASKS))
def test_a_fit_is_bit_identical_with_spans_on_and_off(task):
    off = _fit(task)
    with tracing.collect() as spans:
        on = _fit(task)
    assert spans
    for got, want in zip(on, off):  # forest, history, aux
        got, want = (x if isinstance(x, dict) else vars(x) for x in (got, want))
        assert got.keys() == want.keys()
        for key, b in want.items():
            a = got[key]
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), key
            else:
                assert a == b, key


def test_spans_lie_on_the_profiler_clock():
    with record_function("warm-up"):  # the first range pays the op's lookup
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit("binary")
    spans = tracing.recorded()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    names = {s.name for s in spans}
    assert names == {"train", "train.round", "train.tree", "train.leaves", *LEVEL_STEPS}
    for name in names:
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted(events[name], key=lambda e: e.start_ns())
        assert len(mine) == len(theirs)
        for s, e in zip(mine, theirs):
            assert abs(s.start_ns - e.start_ns()) < 50_000, name
            assert abs(s.end_ns - (e.start_ns() + e.duration_ns())) < 50_000, name


def test_spans_record_under_a_profiler_and_stop_when_it_ends():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("inside", k=1):
            pass
    with tracing.span("after"):
        pass
    assert [(s.name, s.counts) for s in tracing.recorded()] == [("inside", {"k": 1})]


def test_the_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with tracing.collect() as spans:
        for k in range(5):
            with tracing.span("s", k=k):
                pass
    assert [s.counts["k"] for s in spans] == [0, 1, 2] and tracing.dropped() == 2
    tracing.clear()
    assert tracing.recorded() == [] and tracing.dropped() == 0


def test_threads_record_their_own_trees_and_lose_no_span():
    """More threads than cores, each nesting spans, with a short switch
    interval: every span is stored once at its own index, under its own
    thread's parent, in its own thread's trace."""
    threads, roots, depth = 16, 25, 3
    default = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.collect() as spans:
            def work(k):
                for _ in range(roots):
                    with tracing.span("root", thread=k):
                        for level in range(depth):
                            with tracing.span("child", thread=k, level=level):
                                pass
            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(default)
    assert len(spans) == threads * roots * (1 + depth)
    assert [s.index for s in spans] == list(range(len(spans)))
    for s in spans:
        if s.name == "root":
            assert s.parent == -1
        else:
            p = spans[s.parent]
            assert p.name == "root" and p.counts["thread"] == s.counts["thread"]
            assert p.trace == s.trace
    assert len({s.trace for s in spans if s.name == "root"}) == threads * roots


def test_self_time_and_a_span_started_earlier():
    with tracing.collect() as spans:
        t0 = tracing.clock_ns()
        with tracing.span("outer").since(t0):
            with tracing.span("inner"):
                pass
    outer, inner = spans
    assert outer.start_ns == t0 and inner.parent == outer.index
    assert tracing.self_ns(spans) == [outer.duration_ns - inner.duration_ns,
                                      inner.duration_ns]
    assert tracing.self_ns_by_name(spans) == dict(zip(("outer", "inner"),
                                                      tracing.self_ns(spans)))
    assert tracing.last_trace(spans, "outer") == spans
    assert tracing.last_trace(spans, "inner") == []


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(600, 6)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] > 0).astype(np.float32)
    return ToadModel(device="cpu", task="binary", n_bins=16, n_rounds=4,
                     max_depth=3).fit(X, y).compress(), torch.from_numpy(X[:50])


def test_a_request_is_one_predict_root(model):
    m, x = model
    off = m.predictor("packed")(x)
    with tracing.collect() as spans:
        on = m.predictor("packed")(x)
    assert torch.equal(on, off)
    assert [(s.name, s.parent) for s in spans] == [("predict", -1)]


def test_packed_predict_under_a_request_records_check_and_launch(model):
    m, x = model
    predict = m.predictor(CudaBackend())  # packed_predict, on CPU rows its plain version
    off = predict(x)
    with tracing.collect() as spans:
        on = predict(x)
    assert torch.equal(on, off) and torch.equal(on, m.predictor("packed")(x))
    root, check, launch = spans
    assert (root.name, root.parent) == ("predict", -1)
    assert [(s.name, s.parent) for s in (check, launch)] == [
        ("predict.check", root.index), ("predict.launch", root.index)]
    assert launch.counts == {"rows": 50} and check.end_ns <= launch.start_ns
