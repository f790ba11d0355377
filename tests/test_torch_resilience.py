"""The port's serving resilience against the JAX package's, on the CPU.

One counterpart for each test of ``tests/test_resilience.py`` that runs
without a fleet (policy JSON, seeded backoff, the breaker's lifecycle,
typed admission, shedding, deadlines, supervised restarts, retries, the
``cuda -> packed -> reference`` fallback chain, fault plans, the future
ledger, ``EngineStats.merge``), run on the port's engine with
``device="cpu"``; then the places where the two packages must agree
exactly: a policy's JSON crossing between them, ``backoff_delays``, a
``FaultPlan``'s log, and the fallback chain's scores against the JAX
model's ``predict_raw``; and the serve CLI under a policy."""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.fleet.faults as jfaults
from repro.api.model import _FOREST_FIELDS

from repro_torch.api import (
    BadRequest,
    CircuitBreaker,
    DeadlineExceeded,
    EngineError,
    EngineStats,
    EngineStopped,
    GBDTEngine,
    MicroBatchEngine,
    Overloaded,
    ResiliencePolicy,
    ToadModel,
    WorkerCrashed,
    backoff_delays,
    fallback_chain,
)
from repro_torch import tracing
from repro_torch.api import engine as engine_mod
from repro_torch.api.resilience import add_resilience_args, resolve_policy
from repro_torch.fleet import Fault, FaultPlan, FutureLedger, InjectedFault
from repro_torch.gbdt import GBDTConfig, forest_from_numpy

ROOT = Path(__file__).resolve().parents[1]
rng = np.random.default_rng


def _sum_fn(X):
    return np.asarray(X).sum(axis=1, keepdims=True)


def _mk_engine(fn=_sum_fn, d=4, **kw):
    return MicroBatchEngine(fn, d, device="cpu", **kw)


def _rows(n, d=4, seed=0):
    return rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def gbdt_model():
    """(JAX model, the port's model on its forest, rows): the JAX package
    fits once, the port serves the same trees on the CPU."""
    r = rng(0)
    X = r.normal(size=(400, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    jm = japi.ToadModel(task="binary", n_bins=16, n_rounds=8, max_depth=3,
                        learning_rate=0.3).fit(X, y).compress()
    arrays = {f: np.asarray(getattr(jm.forest, f)) for f in _FOREST_FIELDS}
    forest = forest_from_numpy(arrays, jm.forest.n_ensembles, device="cpu")
    port = ToadModel.from_forest(
        forest, config=GBDTConfig(**dataclasses.asdict(jm.config)),
        n_bins=jm.n_bins, device="cpu").compress()
    return jm, port, X


# ---------------------------------------------------------------- policy
def test_policy_json_roundtrip():
    p = ResiliencePolicy(max_queue_depth=32, deadline_ms=50.0, max_retries=2,
                         seed=7, breaker_threshold=5, restart_budget=1)
    assert ResiliencePolicy.from_json(p.to_json()) == p
    assert ResiliencePolicy.from_dict(p.to_dict()) == p
    with pytest.raises(ValueError, match="unknown ResiliencePolicy field"):
        ResiliencePolicy.from_dict({"max_queue_depth": 1, "typo_field": 2})


POLICIES = [
    dict(),
    dict(max_queue_depth=32, deadline_ms=50.0, max_retries=2, seed=7,
         breaker_threshold=5, restart_budget=1),
    dict(max_retries=4, backoff_base_ms=10.0, backoff_mult=2.0,
         backoff_jitter=0.5, seed=3, breaker_cooldown_ms=12.5, fallback=False),
]


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
@pytest.mark.parametrize("fields", POLICIES, ids=["default", "bounded", "backoff"])
def test_policy_json_crosses_between_the_packages(fields, direction):
    port, jax = ResiliencePolicy(**fields), japi.ResiliencePolicy(**fields)
    assert port.to_json() == jax.to_json()  # the same document, key for key
    if direction == "port->jax":
        assert japi.ResiliencePolicy.from_json(port.to_json()) == jax
    else:
        assert ResiliencePolicy.from_json(jax.to_json()) == port


def test_backoff_deterministic_and_exponential():
    p = ResiliencePolicy(max_retries=4, backoff_base_ms=10.0,
                         backoff_mult=2.0, backoff_jitter=0.5, seed=3)
    a, b = list(backoff_delays(p)), list(backoff_delays(p))
    assert a == b and len(a) == 4          # same seed -> same schedule
    assert list(backoff_delays(ResiliencePolicy(max_retries=4, seed=4))) != a
    for i, d in enumerate(a):              # base*mult**i <= d <= that*(1+j)
        lo = 0.010 * 2.0**i
        assert lo <= d <= lo * 1.5


@pytest.mark.parametrize("fields", POLICIES, ids=["default", "bounded", "backoff"])
def test_backoff_delays_equal_jax(fields):
    for n in (None, 6):
        assert list(backoff_delays(ResiliencePolicy(**fields), n)) == \
            list(japi.backoff_delays(japi.ResiliencePolicy(**fields), n))


# ---------------------------------------------------------------- breaker
def test_breaker_lifecycle_with_fake_clock():
    t = [0.0]
    br = CircuitBreaker(threshold=3, cooldown_s=1.0, clock=lambda: t[0])
    assert br.state == "closed" and br.allow()
    br.record_failure(); br.record_failure()
    assert br.state == "closed"            # consecutive failures below N
    br.record_success()
    br.record_failure(); br.record_failure()
    assert br.state == "closed"            # success reset the streak
    br.record_failure()
    assert br.state == "open" and not br.allow()
    t[0] = 1.5                             # cooldown elapsed
    assert br.state == "half_open"
    assert br.allow()                      # the single probe is claimed...
    assert not br.allow()                  # ...concurrent callers blocked
    br.record_failure()                    # probe failed: reopen
    assert br.state == "open"
    t[0] = 3.0
    assert br.allow()
    br.record_success()                    # probe succeeded: closed
    assert br.state == "closed" and br.allow()
    br.trip()
    assert br.state == "open"


# ------------------------------------------------------- typed admission
def test_submit_before_start_and_after_stop_typed():
    eng = _mk_engine()
    with pytest.raises(EngineStopped):
        eng.submit(np.zeros(4, np.float32))
    eng.start()
    assert eng.submit(np.zeros(4, np.float32)).result(5).shape == (1,)
    eng.stop()
    with pytest.raises(EngineStopped):
        eng.submit(np.zeros(4, np.float32))
    assert isinstance(EngineStopped("x"), RuntimeError)  # legacy contract
    # the port's EngineStopped is the typed one, re-exported by the engine
    assert issubclass(EngineStopped, EngineError)
    assert engine_mod.EngineStopped is EngineStopped


def test_stop_race_resolves_every_future():
    """Submitters hammering across stop(): every admitted future resolves
    (the window between the stop-flag check and the final drain)."""
    eng = _mk_engine(max_wait_ms=0.5).start()
    ledger = FutureLedger()
    stop_submitting = threading.Event()

    def submitter(seed):
        X = _rows(400, seed=seed)
        for x in X:
            if stop_submitting.is_set():
                return
            try:
                ledger.track(eng.submit(x))
            except EngineStopped:
                return

    threads = [threading.Thread(target=submitter, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    eng.stop()
    stop_submitting.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(ledger) > 0
    ledger.assert_all_resolved(timeout=5.0)
    # a late submit stays typed
    with pytest.raises(EngineStopped):
        eng.submit(np.zeros(4, np.float32))


def test_wrong_width_row_resolves_future_not_worker():
    eng = _mk_engine().start()
    bad = eng.submit(np.zeros(7, np.float32))     # wrong width
    with pytest.raises(BadRequest):
        bad.result(5)
    # the worker never saw it and keeps serving
    good = eng.submit(np.full(4, 2.0, np.float32))
    assert good.result(5) == pytest.approx(8.0)
    eng.stop()


def test_batch_exception_reaches_every_future():
    boom = ValueError("boom")

    def bad_fn(X):
        if X.any():
            raise boom
        return _sum_fn(X)                          # warm-up (zeros) passes

    eng = _mk_engine(bad_fn, max_wait_ms=50.0).start()
    futs = [eng.submit(np.full(4, 1.0 + i, np.float32)) for i in range(16)]
    eng.stop()
    excs = [f.exception(timeout=5) for f in futs]
    assert all(e is boom for e in excs)            # every future, same error


def test_step_timer_gets_every_served_batch_split():
    """Each served batch is an ``engine.batch`` span (``repro_torch.
    tracing``) with one child span a worker step, in order; a failed batch
    has no ``engine.resolve``."""

    def fn(X):
        if (X == 9.0).any():
            raise ValueError("boom")
        time.sleep(0.002)
        return _sum_fn(X)

    with tracing.collect() as spans:
        eng = _mk_engine(fn, max_wait_ms=20.0).start()
        got = [f.result(5) for f in [eng.submit(x) for x in _rows(16)]]
        bad = eng.submit(np.full(4, 9.0, np.float32))
        with pytest.raises(ValueError):
            bad.result(5)
        eng.stop()
    s = eng.stats()
    assert np.allclose(np.stack(got), _sum_fn(_rows(16)))
    batches = [b for b in spans if b.name == "engine.batch"]
    steps = {b.index: [c for c in spans if c.parent == b.index] for b in batches}
    served = [b for b in batches if steps[b.index][-1].name == "engine.resolve"]
    assert len(served) == s.n_batches >= 1 and len(batches) == s.n_batches + 1
    assert sum(b.counts["requests"] for b in served) == 16
    for b in batches:
        names = [c.name for c in steps[b.index]]
        want = ["engine." + k for k in engine_mod.WORKER_STEPS]
        assert names == (want if b in served else want[:-1])
        assert b.start_ns == steps[b.index][0].start_ns
        assert all(b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns for c in steps[b.index])
        assert len({b.trace} | {c.trace for c in steps[b.index]}) == 1
    assert all(steps[b.index][2].duration_ns >= 2_000_000 for b in served)


# ----------------------------------------------------------- backpressure
def test_bounded_queue_sheds_with_overloaded():
    def slow(X):
        time.sleep(0.03)
        return _sum_fn(X)

    pol = ResiliencePolicy(max_queue_depth=4)
    eng = _mk_engine(slow, policy=pol, max_batch=2).start()
    ledger = FutureLedger()
    for x in _rows(64):
        ledger.track(eng.submit(x))
    out = ledger.outcomes(timeout=20.0)
    eng.stop()
    s = eng.stats()
    assert out.get("Overloaded", 0) > 0
    assert out.get("Overloaded", 0) == s.n_shed
    assert out.get("ok", 0) + s.n_shed == 64       # nothing stranded or lost


def test_deadline_enforced_at_dequeue_and_result():
    def slow(X):
        time.sleep(0.05)
        return _sum_fn(X)

    pol = ResiliencePolicy(deadline_ms=60.0)
    eng = _mk_engine(slow, policy=pol, max_batch=1).start()
    ledger = FutureLedger()
    for x in _rows(24):
        ledger.track(eng.submit(x))                # ~1.2 s of work, 60 ms budget
    out = ledger.outcomes(timeout=20.0)
    eng.stop()
    s = eng.stats()
    assert out.get("DeadlineExceeded", 0) > 0
    # the dequeue triage fired too (cheaper than a wasted predict), and its
    # count never exceeds what clients observed
    assert 0 < s.n_deadline_expired <= out["DeadlineExceeded"]
    assert out.get("ok", 0) >= 1                   # early requests made it


def test_slow_predict_fault_blows_result_deadline():
    plan = FaultPlan([Fault(point="predict", action="sleep", sleep_s=0.2)])
    pol = ResiliencePolicy(deadline_ms=50.0)
    eng = _mk_engine(policy=pol, faults=plan).start()
    fut = eng.submit(np.zeros(4, np.float32))
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExceeded):
        fut.result()                               # no explicit timeout needed
    assert time.perf_counter() - t0 < 0.15         # returned at the deadline
    eng.stop()
    assert plan.n_fired("predict") >= 1


# ------------------------------------------------------------- supervisor
def test_worker_crash_restart_then_serve():
    plan = FaultPlan([Fault(point="worker", at=(1,), count=1, message="die")])
    eng = _mk_engine(policy=ResiliencePolicy(restart_budget=2),
                     faults=plan).start()
    ledger = FutureLedger()
    for x in _rows(12):
        ledger.track(eng.submit(x))
        time.sleep(0.01)                            # spread across batches
    out = ledger.outcomes(timeout=20.0)
    eng.stop()
    assert out.get("WorkerCrashed", 0) >= 1         # the in-flight batch
    assert out.get("ok", 0) >= 1                    # served after restart
    assert eng.stats().n_worker_restarts == 1


def test_worker_crash_budget_exhaustion():
    plan = FaultPlan([Fault(point="worker", message="die")])  # every batch
    eng = _mk_engine(policy=ResiliencePolicy(restart_budget=1),
                     faults=plan).start()
    ledger = FutureLedger()
    with pytest.raises(EngineStopped):
        for x in _rows(200):
            ledger.track(eng.submit(x))
            time.sleep(0.005)
    out = ledger.outcomes(timeout=20.0)
    eng.stop()
    assert set(out) == {"WorkerCrashed"}            # typed, none stranded
    assert eng.stats().n_worker_restarts == 1       # budget respected


def test_restarted_worker_selects_the_engine_device(monkeypatch):
    """The worker selects the engine's device each time its loop starts,
    the restart included (the restarted loop runs on the same thread)."""
    selected = []
    eng = _mk_engine(policy=ResiliencePolicy(restart_budget=2),
                     faults=FaultPlan([Fault(point="worker", at=(0,), count=1)]))
    eng.device = engine_mod.torch.device("cuda", 0)  # pretend: no call reaches it
    monkeypatch.setattr(engine_mod.torch.cuda, "set_device", selected.append)
    eng.start()
    fut = eng.submit(np.ones(4, np.float32))
    with pytest.raises(WorkerCrashed):
        fut.result(5)
    assert eng.submit(np.ones(4, np.float32)).result(5) == pytest.approx(4.0)
    eng.stop()
    assert selected == [eng.device, eng.device]


# ------------------------------------------------------ retry + fallback
def test_predict_retry_recovers_transient_fault():
    plan = FaultPlan([Fault(point="predict", at=(0,), count=1)])
    pol = ResiliencePolicy(max_retries=2, backoff_base_ms=1.0)
    eng = _mk_engine(policy=pol, faults=plan).start()
    fut = eng.submit(np.full(4, 1.0, np.float32))
    assert fut.result(5) == pytest.approx(4.0)
    eng.stop()
    s = eng.stats()
    assert s.n_predict_retries >= 1
    assert s.breaker_state["primary"] == "closed"   # retry, not a failure


def test_fallback_chain_serves_when_primary_fails():
    def bad_primary(X):
        if X.any():  # the port has no degraded start: warm-up (zeros) passes
            raise RuntimeError("kernel fault")
        return _sum_fn(X)

    pol = ResiliencePolicy(breaker_threshold=1, breaker_cooldown_ms=60_000.0)
    eng = MicroBatchEngine(bad_primary, 4, policy=pol,
                           fallbacks=[("good", _sum_fn)],
                           backend_name="bad", device="cpu").start()
    futs = [eng.submit(x) for x in _rows(8)]
    got = np.stack([f.result(5) for f in futs])
    assert got == pytest.approx(_sum_fn(_rows(8)), abs=1e-6)
    s = eng.stats()
    eng.stop()
    assert s.breaker_state == {"bad": "open", "good": "closed"}
    assert s.active_backend == "good"
    assert s.n_fallback_batches >= 1


def test_breaker_half_open_recovers_primary():
    fail_until = 3
    calls = {"n": 0}

    def flaky(X):
        calls["n"] += 1
        # the port has no degraded start, so the primary passes its one
        # warm-up call (max_batch=1: one bucket) and then fails 3 batches
        if 1 < calls["n"] <= 1 + fail_until:
            raise RuntimeError("transient kernel fault")
        return _sum_fn(X)

    pol = ResiliencePolicy(breaker_threshold=1, breaker_cooldown_ms=30.0)
    eng = MicroBatchEngine(flaky, 4, policy=pol,
                           fallbacks=[("good", _sum_fn)],
                           backend_name="flaky", max_batch=1, device="cpu")
    eng.start()                                     # warm-up passes
    deadline = time.perf_counter() + 10.0
    while time.perf_counter() < deadline:
        eng.submit(np.ones(4, np.float32)).result(5)
        if eng.stats().active_backend == "flaky":
            break
        time.sleep(0.02)                            # let the cooldown elapse
    s = eng.stats()
    eng.stop()
    assert s.active_backend == "flaky"              # probe succeeded
    assert s.breaker_state["flaky"] == "closed"
    assert s.n_fallback_batches >= 1                # degraded service first


def test_warm_up_failure_raises_even_with_fallbacks():
    """No degraded start in the port (the JAX package trips the breaker and
    serves on): a primary that cannot serve its warm-up batch fails
    ``start()``, so a kernel that does not build or launch is never hidden
    behind the chain, and the fallbacks are never called."""
    fell_back = []

    def good(X):
        fell_back.append(len(X))
        return _sum_fn(X)

    def broken(X):
        raise RuntimeError("kernel did not build")

    eng = MicroBatchEngine(broken, 4, policy=ResiliencePolicy(),
                           fallbacks=[("good", good)],
                           backend_name="cuda", device="cpu")
    with pytest.raises(RuntimeError, match="did not build"):
        eng.start()
    assert fell_back == []
    with pytest.raises(EngineStopped):
        eng.submit(np.zeros(4, np.float32))


def test_all_breakers_open_still_attempts_last_resort():
    boom = RuntimeError("down")

    def bad(X):
        raise boom

    pol = ResiliencePolicy(breaker_threshold=1, breaker_cooldown_ms=60_000.0)
    eng = MicroBatchEngine(bad, 4, policy=pol, backend_name="only", device="cpu")
    with pytest.raises(RuntimeError):
        eng.start()                                 # no fallback: warm-up raises
    eng = MicroBatchEngine(_sum_fn, 4, policy=pol, backend_name="only",
                           faults=FaultPlan([Fault(point="predict")]),
                           device="cpu")
    eng.start()
    f1 = eng.submit(np.zeros(4, np.float32))        # opens the breaker
    with pytest.raises(InjectedFault):              # the real error, typed
        f1.result(5)
    f2 = eng.submit(np.zeros(4, np.float32))        # breaker open: bypassed
    with pytest.raises(InjectedFault):
        f2.result(5)
    eng.stop()


@pytest.mark.parametrize("early_exit", [False, True], ids=["full", "early-exit"])
def test_gbdt_engine_fallback_parity(gbdt_model, early_exit):
    """A dead primary backend falls back inside the <=1e-5 parity contract,
    held against the JAX model's ``predict_raw``; under early exit the
    fallback is a full-evaluation predictor (its scores are the full
    ensemble's)."""
    from repro_torch.api import EarlyExitPolicy

    jm, model, X = gbdt_model
    plan = FaultPlan([Fault(point="predict", backend="packed")])
    pol = ResiliencePolicy(breaker_threshold=1, breaker_cooldown_ms=60_000.0)
    eng = GBDTEngine(model, backend="packed", policy=pol, faults=plan,
                     max_wait_ms=5.0,
                     early_exit=EarlyExitPolicy(0.0) if early_exit else None)
    assert [n for n, _ in eng._chain] == ["packed", "reference"]
    with eng:
        futs = [eng.submit(x) for x in X[:32]]
        got = np.stack([f.result(10) for f in futs])
    ref = np.asarray(jm.predict(X[:32], backend="reference"))
    assert np.abs(got - ref).max() <= 1e-5
    s = eng.stats()
    assert s.active_backend == "reference"
    assert s.breaker_state["packed"] == "open"
    assert s.n_fallback_batches == s.n_batches >= 1


def test_fallback_chain_order(gbdt_model):
    _, model, _ = gbdt_model
    assert [n for n, _ in fallback_chain(model, "cuda")] == \
        ["packed", "reference"]
    assert [n for n, _ in fallback_chain(model, "packed")] == ["reference"]
    assert [n for n, _ in fallback_chain(model, "reference")] == []
    # unknown/custom primaries degrade through the portable backends
    assert [n for n, _ in fallback_chain(model, "custom")] == \
        ["packed", "reference"]


def test_no_policy_no_chain_and_fallbacks_build_lazily(gbdt_model):
    """Without a policy (or with ``fallback`` off) the engine has no chain;
    with one, a fallback builds its predictor at its first call."""
    jm, model, X = gbdt_model
    assert [n for n, _ in GBDTEngine(model, backend="packed")._chain] == ["packed"]
    off = ResiliencePolicy(fallback=False)
    assert [n for n, _ in GBDTEngine(model, backend="packed", policy=off)._chain] == \
        ["packed"]
    model._predict_fns.pop("reference", None)
    eng = GBDTEngine(model, backend="packed", policy=ResiliencePolicy())
    assert "reference" not in model._predict_fns     # built at first use only
    out = eng._chain[1][1](X[:4])
    assert "reference" in model._predict_fns
    np.testing.assert_allclose(np.asarray(out), jm.predict(X[:4]), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- faults
def _drive(plan, fault_error):
    for i in range(20):
        for point, model in (("predict", "a"), ("predict", "b"), ("worker", "")):
            try:
                plan.fire(point, model=model, backend="cuda" if i % 3 else "packed")
            except fault_error:
                pass
    return plan.log


def test_faultplan_deterministic_and_filtered():
    mk = lambda: FaultPlan(
        [Fault(point="predict", p=0.5, model="a"),
         Fault(point="worker", at=(2, 4))], seed=11)
    p1, p2 = mk(), mk()
    for plan in (p1, p2):
        for i in range(20):
            for point, model in (("predict", "a"), ("predict", "b"),
                                 ("worker", "")):
                try:
                    plan.fire(point, model=model)
                except InjectedFault:
                    pass
    assert p1.log == p2.log                         # same seed, same schedule
    assert all(m == "a" for pt, m, *_ in p1.log if pt == "predict")
    assert [rec[3] for rec in p1.log if rec[0] == "worker"] == [2, 4]
    with pytest.raises(ValueError, match="unknown fault point"):
        Fault(point="nope")
    with pytest.raises(ValueError, match="unknown fault action"):
        Fault(point="predict", action="explode")


SCHEDULES = {
    "probabilistic": (lambda F: [F(point="predict", p=0.5, model="a"),
                                 F(point="worker", at=(2, 4))], 11),
    "backend-capped": (lambda F: [F(point="predict", backend="cuda", count=3),
                                  F(point="worker", after=15, count=2)], 0),
    "sleep-and-raise": (lambda F: [F(point="predict", action="sleep", at=(1, 5)),
                                   F(point="predict", p=0.3, model="b")], 5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_faultplan_log_equals_jax(name):
    faults, seed = SCHEDULES[name]
    port = _drive(FaultPlan(faults(Fault), seed=seed), InjectedFault)
    jax = _drive(jfaults.FaultPlan(faults(jfaults.Fault), seed=seed),
                 jfaults.InjectedFault)
    assert port == jax and len(port) > 0


def test_future_ledger_flags_stranded_future():
    led = FutureLedger()
    led.track(concurrent.futures.Future())          # never resolved
    with pytest.raises(AssertionError, match="1 of 1 futures stranded"):
        led.assert_all_resolved(timeout=0.1)


# ----------------------------------------------------------------- stats
def test_stats_merge_sums_resilience_counters():
    a = EngineStats(10, 2, 1.0, 10.0, 5.0, 1.0, 1.0, 2.0, n_shed=3,
                    n_deadline_expired=1, n_worker_restarts=1,
                    n_predict_retries=2, n_fallback_batches=1,
                    breaker_state={"cuda": "open"}, active_backend="packed")
    b = EngineStats(30, 3, 2.0, 15.0, 10.0, 2.0, 2.0, 4.0, n_shed=1,
                    n_deadline_expired=4, n_worker_restarts=0)
    m = EngineStats.merge([a, b])
    assert (m.n_shed, m.n_deadline_expired, m.n_worker_restarts) == (4, 5, 1)
    assert (m.n_predict_retries, m.n_fallback_batches) == (2, 1)
    assert m.breaker_state == {} and m.active_backend == ""  # per-engine facts
    assert m.n_requests == 40
    d = m.as_dict()
    assert d["n_shed"] == 4 and "breaker_state" in d
    # the same merge as the JAX package's, field for field
    ja = japi.EngineStats(**dataclasses.asdict(a))
    jb = japi.EngineStats(**dataclasses.asdict(b))
    assert japi.EngineStats.merge([ja, jb]).as_dict() == d


# ---------------------------------------------------------------- the CLI
def test_resolve_policy_needs_a_flag(tmp_path):
    import argparse

    ap = argparse.ArgumentParser()
    add_resilience_args(ap)
    assert resolve_policy(ap.parse_args([])) is None    # no flag, no policy
    # a deadline or a bounded queue alone never turns the fallback chain on
    assert resolve_policy(ap.parse_args(["--deadline-ms", "40", "--max-queue", "8"])) == \
        ResiliencePolicy(deadline_ms=40.0, max_queue_depth=8, fallback=False)
    spec = tmp_path / "p.json"
    spec.write_text(japi.ResiliencePolicy(max_retries=2, seed=9).to_json())
    got = resolve_policy(ap.parse_args(["--resilience", str(spec),
                                        "--deadline-ms", "40"]))
    assert got == ResiliencePolicy(max_retries=2, seed=9, deadline_ms=40.0)


def test_serve_cli_prints_its_resilience_line():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "toad-gbdt",
         "--device", "cpu", "--smoke", "--deadline-ms", "1000", "--max-queue", "64"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    line = next(ln for ln in res.stdout.splitlines() if ln.startswith("resilience:"))
    shed = int(line.split("shed=")[1].split()[0])
    expired = int(line.split("deadline_expired=")[1].split()[0])
    served = int(res.stdout.split("served ")[1].split()[0])
    assert served + shed + expired == 256
    assert "fallback_batches=0" in line and "active=packed" in line


def test_serve_cli_fails_when_a_fallback_served(tmp_path, monkeypatch):
    """The CLI injects no fault, so a batch that a fallback served means the
    primary failed: the run exits non-zero even though the fallback's
    scores pass parity."""
    from repro_torch.api.model import ToadModel
    from repro_torch.launch import serve

    real = ToadModel.predictor

    def predictor(self, backend=None):
        fn = real(self, backend)
        if backend != "packed":
            return fn

        def faulty(X):  # passes the zero warm-up rows, fails real ones
            if bool(torch.as_tensor(X).any()):
                raise RuntimeError("primary down")
            return fn(X)

        return faulty

    monkeypatch.setattr(ToadModel, "predictor", predictor)
    spec = tmp_path / "p.json"
    spec.write_text(ResiliencePolicy(fallback=True).to_json())
    with pytest.raises(SystemExit, match="served by a fallback"):
        serve.main(["--arch", "toad-gbdt", "--device", "cpu", "--smoke",
                    "--backend", "packed", "--resilience", str(spec)])
