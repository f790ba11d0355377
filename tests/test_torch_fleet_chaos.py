"""The port's fleet under faults and with streaming entries, on the CPU.

The counterparts of the fleet tests of ``tests/test_resilience.py``
(failed-swap rollback, pruned retire threads, stats during retirement,
per-model breakers and shedding, every future resolved under crashes) and
of ``tests/test_stream.py`` (streaming admission order and log, progressive
fleet serving, final scores by default, header-table dedup), run on the
port with ``device="cpu"``.  The models are the port's own (trained on the
CPU, saved in the shared format); the JAX package loads the same artifacts
to show that one :class:`FaultPlan` fires on the same calls in both fleets.
None of these tests gives a primary a failing warm-up: the port's engines
make no degraded start (a primary that fails its warm-up raises out of the
route, tested here too), where the JAX package's trip the breaker and serve
on."""

import logging
import threading
import time

import numpy as np
import pytest

import repro.api as japi
import repro.fleet as jfleet

import repro_torch.fleet as tfleet
from repro_torch.api import (
    CompressionSpec,
    EngineStopped,
    ResiliencePolicy,
    ToadModel,
    save_streaming,
)
from repro_torch.fleet import (
    Fault,
    FaultPlan,
    FleetEngine,
    FutureLedger,
    InjectedFault,
    ModelRegistry,
)

ATOL = 1e-5
CPU = "cpu"


def _model(X, y, n_rounds):
    return ToadModel(task="binary", n_bins=16, n_rounds=n_rounds, max_depth=3,
                     learning_rate=0.3, device=CPU).fit(X, y).compress()


@pytest.fixture(scope="module")
def gbdt_model():
    r = np.random.default_rng(0)
    X = r.normal(size=(400, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    return _model(X, y, 8), X


@pytest.fixture(scope="module")
def fleet_dir(tmp_path_factory, gbdt_model):
    model, X = gbdt_model
    d = tmp_path_factory.mktemp("resilience_fleet")
    model.save(str(d / "m_a.toad"))
    m2 = _model(X, (X[:, 2] > 0).astype(np.float32), 6)
    m2.save(str(d / "m_b.toad"))
    m2.save(str(d / "swap_target.toad"))
    return d


def _registry(fleet_dir, **kw):
    return ModelRegistry.from_dir(str(fleet_dir), device=CPU, **kw)


# --------------------------------------------- tests/test_resilience.py
def test_fleet_swap_failure_leaves_old_version_serving(fleet_dir, gbdt_model):
    _, X = gbdt_model
    registry = _registry(fleet_dir)
    # arm the admit fault *after* initial admission: the next _admit dies
    registry._faults = FaultPlan(
        [Fault(point="admit", model="m_a", message="load error mid-swap")])
    with FleetEngine(registry, max_wait_ms=1.0) as engine:
        before = engine.version("m_a")
        ref = engine.submit("m_a", X[0]).result(10)
        with pytest.raises(InjectedFault):
            engine.swap("m_a", str(fleet_dir / "swap_target.toad"))
        assert engine.version("m_a") == before       # old version serving
        got = engine.submit("m_a", X[0]).result(10)
        assert got == pytest.approx(ref, abs=1e-6)
        registry._faults = None                      # fault cleared: swap lands
        assert engine.swap(
            "m_a", str(fleet_dir / "swap_target.toad")).version == before + 1


def test_fleet_retire_threads_pruned(fleet_dir):
    registry = _registry(fleet_dir)
    with FleetEngine(registry, max_wait_ms=0.5) as engine:
        engine.warm("m_b")
        for _ in range(12):
            engine.swap("m_b", str(fleet_dir / "swap_target.toad"))
        engine.drain()
        engine.swap("m_b", str(fleet_dir / "swap_target.toad"))
        # pruning keeps the list bounded by *live* drains, not swap history
        assert len(engine._retire_threads) <= 2
        assert engine.stats().n_retired >= 12


def test_fleet_stats_concurrent_with_retire(fleet_dir, gbdt_model):
    _, X = gbdt_model
    registry = _registry(fleet_dir)
    errors = []

    def poll_stats(engine, stop):
        try:
            while not stop.is_set():
                s = engine.stats()
                assert s.n_hot >= 0 and s.fleet.n_requests >= 0
        except Exception as e:  # pragma: no cover - the failure under test
            errors.append(e)

    with FleetEngine(registry, max_wait_ms=0.5) as engine:
        stop = threading.Event()
        t = threading.Thread(target=poll_stats, args=(engine, stop))
        t.start()
        for _ in range(8):
            engine.submit("m_b", X[0]).result(10)
            engine.swap("m_b", str(fleet_dir / "swap_target.toad"))
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive()
    assert errors == []


def test_fleet_resilience_counters_and_shed(fleet_dir, gbdt_model):
    _, X = gbdt_model
    registry = _registry(fleet_dir)
    plan = FaultPlan([Fault(point="predict", action="sleep", sleep_s=0.02,
                            model="m_a")])
    pol = ResiliencePolicy(max_queue_depth=2)
    ledger = FutureLedger()
    with FleetEngine(registry, policy=pol, faults=plan, max_batch=2,
                     max_wait_ms=0.5) as engine:
        for i in range(64):
            ledger.track(engine.submit("m_a", X[i % len(X)]))
        out = ledger.outcomes(timeout=30.0)
        stats = engine.stats()
    assert stats.n_shed > 0 and out.get("Overloaded", 0) == stats.n_shed
    assert out.get("ok", 0) + stats.n_shed == 64
    assert stats.breaker_state["m_a"]                # per-model breaker view
    assert stats.active_backend["m_a"] in ("packed", "reference", "cuda")
    assert stats.as_dict()["n_shed"] == stats.n_shed


def test_fleet_stop_resolves_everything_under_crashes(fleet_dir, gbdt_model):
    """The end-to-end chaos scenario: crashes + floods, then stop() — every
    future across the fleet resolves."""
    _, X = gbdt_model
    registry = _registry(fleet_dir)
    plan = FaultPlan([Fault(point="worker", model="m_a", at=(2,), count=1),
                      Fault(point="predict", model="m_b", at=(3,), count=1)])
    pol = ResiliencePolicy(max_queue_depth=16, restart_budget=2)
    ledger = FutureLedger()
    with FleetEngine(registry, policy=pol, faults=plan,
                     max_wait_ms=0.5) as engine:
        for i in range(48):
            for mid in ("m_a", "m_b"):
                try:
                    ledger.track(engine.submit(mid, X[i % len(X)]))
                except EngineStopped:
                    pass
            time.sleep(0.002)
    out = ledger.outcomes(timeout=30.0)
    allowed = {"ok", "Overloaded", "DeadlineExceeded", "WorkerCrashed",
               "EngineStopped", "InjectedFault"}
    assert set(out) <= allowed                       # typed outcomes only
    assert out.get("ok", 0) > 0


# ------------------------------------------------------- the port's rules
def test_breaker_opens_for_the_faulted_model_only(fleet_dir, gbdt_model):
    """Injected primary faults on one model open *its* breaker; the other
    models keep serving on their primary."""
    _, X = gbdt_model
    registry = _registry(fleet_dir)
    plan = FaultPlan([Fault(point="predict", model="m_a", backend="packed",
                            count=3)])
    pol = ResiliencePolicy(fallback=True, breaker_threshold=3,
                           breaker_cooldown_ms=60_000.0)
    with FleetEngine(registry, backend="packed", policy=pol, faults=plan,
                     max_wait_ms=0.5) as engine:
        for i in range(4):
            for mid in ("m_a", "m_b", "swap_target"):
                got = engine.submit(mid, X[i]).result(10)
                ref = registry.get(mid).model.predict(X[i:i + 1], backend="reference")[0]
                np.testing.assert_allclose(got, ref, rtol=ATOL, atol=ATOL)
        s = engine.stats()
    assert s.breaker_state["m_a"]["packed"] == "open"
    assert s.active_backend == {"m_a": "reference", "m_b": "packed",
                                "swap_target": "packed"}
    assert all(s.breaker_state[m]["packed"] == "closed" for m in ("m_b", "swap_target"))
    assert s.per_model["m_a"].n_fallback_batches == 4
    assert plan.n_fired("predict") == 3


def test_failing_warm_up_raises_out_of_the_route(fleet_dir, gbdt_model, monkeypatch):
    """No degraded start: a primary that fails its warm-up raises out of
    ``submit``/``warm`` though the policy has a fallback chain, and leaves
    the LRU as it was; the other models serve on."""
    _, X = gbdt_model
    registry = _registry(fleet_dir)
    bad = registry.get("m_a").model
    real = ToadModel.predictor

    def predictor(self, backend=None):
        fn = real(self, backend)
        if self is not bad or backend == "reference":
            return fn

        def broken(rows):
            raise RuntimeError("kernel did not build")

        return broken

    monkeypatch.setattr(ToadModel, "predictor", predictor)
    with FleetEngine(registry, policy=ResiliencePolicy(fallback=True),
                     max_wait_ms=0.5) as engine:
        with pytest.raises(RuntimeError, match="did not build"):
            engine.submit("m_a", X[0])
        with pytest.raises(RuntimeError, match="did not build"):
            engine.warm("m_a")
        assert engine.stats().n_hot == 0
        assert engine.submit("m_b", X[0]).result(10).shape == (1,)
        assert list(engine.stats().per_model) == ["m_b"]


def _chaos(pkg, registry, X, target):
    """One FaultPlan over a fleet, each request alone in its batch so every
    occurrence count is deterministic: returns the outcomes and the plan's
    log."""
    plan = pkg.FaultPlan([
        pkg.Fault(point="admit", model="m_a", at=(1,)),
        pkg.Fault(point="predict", model="m_b", at=(1, 3)),
        pkg.Fault(point="worker", model="m_b", at=(5,), count=1),
    ])
    registry._faults = plan
    pol = type(registry).__module__.startswith("repro_torch")
    policy = (ResiliencePolicy if pol else japi.ResiliencePolicy)(
        max_retries=0, restart_budget=2, fallback=False)
    outcomes = []
    with pkg.FleetEngine(registry, backend="packed", policy=policy, faults=plan,
                         max_wait_ms=0.5) as engine:
        for i in range(8):
            exc = engine.submit("m_b", X[i]).exception(timeout=30)
            outcomes.append("ok" if exc is None else type(exc).__name__)
        for _ in range(3):
            try:
                engine.swap("m_a", target)
                outcomes.append("swapped")
            except Exception as e:  # the injected admit fault
                outcomes.append(type(e).__name__)
    return outcomes, list(plan.log)


def test_faultplan_fires_on_the_same_calls_as_jax(fleet_dir, gbdt_model):
    _, X = gbdt_model
    target = str(fleet_dir / "swap_target.toad")
    port = _chaos(tfleet, _registry(fleet_dir), X, target)
    jax = _chaos(jfleet, jfleet.ModelRegistry.from_dir(str(fleet_dir)), X, target)
    assert port == jax
    assert port[0] == ["ok", "InjectedFault", "ok", "InjectedFault", "ok",
                       "WorkerCrashed", "ok", "ok", "swapped", "InjectedFault",
                       "swapped"]


# ------------------------------------------------- tests/test_stream.py
def _fit(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    m = ToadModel(task="binary", n_bins=16, n_rounds=12, max_depth=3,
                  learning_rate=0.3, device=CPU)
    return m.fit(X, y), X


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixed")
    m, X = _fit()
    m = m.compress(spec=CompressionSpec.codebook_full(6, 4))
    save_streaming(m, str(d / "a_pack.toadpack"))
    m.save(str(d / "b_classic.toad"))
    m2, _ = _fit(seed=5)
    m2 = m2.compress(spec=CompressionSpec.thr_codebook(6))
    save_streaming(m2, str(d / "c_pack.toadpack"))
    return d, m, X


def test_registry_streaming_admission_order_and_log(mixed_dir, caplog):
    d, _, _ = mixed_dir
    with caplog.at_level(logging.INFO, logger="repro_torch.fleet.registry"):
        reg = ModelRegistry.from_dir(str(d), streaming=True, device=CPU)
    assert reg.ids() == ["a_pack", "b_classic", "c_pack"]  # basename order
    assert reg.get("a_pack").is_streaming
    assert not reg.get("b_classic").is_streaming
    admitted = [r.message for r in caplog.records if "admitted" in r.message]
    assert len(admitted) == 3
    # one line per model, in admission order, with elapsed milliseconds
    assert [m.split()[1] for m in admitted] == ["a_pack", "b_classic", "c_pack"]
    assert all("ms" in m for m in admitted)
    assert "streaming" in admitted[0] and "streaming" not in admitted[1]


def test_fleet_serves_streaming_entries_with_parity(mixed_dir):
    d, _, X = mixed_dir
    reg = ModelRegistry.from_dir(str(d), streaming=True, device=CPU)
    with FleetEngine(reg, max_batch=32, streaming=True) as eng:
        assert eng.wait_complete()  # every pack fully streamed in
        for mid in reg.ids():
            got = np.stack([eng.submit(mid, x).result() for x in X[:16]])
            ref = reg.get(mid).model.predict(X[:16], backend="reference")
            np.testing.assert_allclose(got, ref, rtol=ATOL, atol=ATOL)
    stats = eng.stats()
    assert set(stats.streaming) == {"a_pack", "c_pack"}
    assert all(s["score_is_final"] for s in stats.streaming.values())


def test_fleet_default_waits_for_final_scores(mixed_dir):
    d, _, X = mixed_dir
    reg = ModelRegistry.from_dir(str(d), streaming=False, device=CPU)
    with FleetEngine(reg, max_batch=32) as eng:  # streaming not opted into
        got = eng.predict("a_pack", X[:16])
        ref = reg.get("a_pack").model.predict(X[:16], backend="reference")
        np.testing.assert_allclose(got, ref, rtol=ATOL, atol=ATOL)
    assert reg.get("a_pack").model.streaming_stats()["score_is_final"]


def test_progressive_model_dedups_header_tables(mixed_dir):
    d, _, _ = mixed_dir
    reg = ModelRegistry.from_dir(str(d), streaming=True, device=CPU)
    report = reg.memory_report()
    # a_pack (streaming) and b_classic (same ladder) share their tables
    assert report["dedup_saved_bytes"] > 0
    assert report["models"]["a_pack"]["shared_bytes"] > 0
    # ... and on the device, one leaf tensor
    a, b = reg.get("a_pack").model, reg.get("b_classic").model
    assert a.scorer._leaf_values is b.device_packed().leaf_values


def test_streaming_fleet_report_equals_jax(mixed_dir):
    """The same port-written mixed directory admitted by both packages."""
    d, _, _ = mixed_dir
    port = ModelRegistry.from_dir(str(d), streaming=False, device=CPU)
    jax = jfleet.ModelRegistry.from_dir(str(d), streaming=False)
    assert port.memory_report() == jax.memory_report()
    assert port.pool.stats() == jax.pool.stats()
