"""FleetEngine: one router, many models, warm-backend LRU, hot-swap drain.

The port's copy of ``repro.fleet.engine``.  Routes single-row requests by
``model_id`` to a per-model :class:`~repro_torch.api.engine.MicroBatchEngine`
worker, so requests for the same model batch *across tenants* — the
cross-tenant occupancy shows up in ``EngineStats.batch_occupancy``.
Backends are built lazily and kept in an LRU of at most ``max_hot`` warm
workers; a cold model pays its warm-up on first use (``warm()`` pre-pays
it), an evicted one drains its queue in the background before its worker
exits.  Every worker runs on its model's device and selects it each time
it (re)starts.

On a card, a classic entry's primary backend is ``cuda`` (B1, the
``packed_predict`` kernel; ``auto`` resolves to it or raises, never quietly
to ``packed``), and with an early-exit policy its
:class:`~repro_torch.api.engine.EarlyExitPredictor` runs B3
(``packed_predict_early_exit``) on exit tables made once per model.
Streaming entries score through their progressive scorer (the torch
traversal), as in the JAX package, and their primary is named for what it
runs (``packed``; the JAX package names it after the auto backend).

**Resilience**: constructed with a
:class:`~repro_torch.api.resilience.ResiliencePolicy`, every per-model backend
gets the bounded queue / deadline / supervisor / breaker+fallback
machinery of :class:`~repro_torch.api.engine.MicroBatchEngine`, with the
fallback chain (``cuda -> packed -> reference``, on the model's device)
built per model only when the policy sets ``fallback``.
:class:`FleetStats` surfaces the per-model breaker state and active
backend plus fleet-wide shed / expiry / restart counters.  A ``faults=``
:class:`~repro_torch.fleet.faults.FaultPlan` threads through to every
backend (tagged by model_id) and, via the registry, to artifact admission
— the chaos tests' hook.  Unlike the JAX package, a primary whose warm-up
fails raises out of the route (``submit``, ``predict``, ``warm``): there
is no degraded start behind the chain.

**Hot-swap semantics**: the registry bumps an entry's version atomically;
the router compares the cached backend's version against the registry on
every route.  On mismatch the old backend is retired — its worker drains
every already-queued request against the *old* model (those futures
complete with old-version scores) — while new requests immediately build
and hit the new version.  No request is dropped and no request ever mixes
versions within a batch.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np

from repro_torch.api.engine import (
    EarlyExitPredictor,
    EngineStats,
    MicroBatchEngine,
    fallback_chain,
)
from repro_torch.fleet.registry import ModelRegistry, UnknownModelError

__all__ = ["FleetEngine", "FleetStats", "UnknownModelError"]


@dataclasses.dataclass
class FleetStats:
    """Per-model + fleet-wide serving statistics."""

    per_model: dict          # model_id -> EngineStats (hot backends)
    fleet: EngineStats       # merged across hot + retired backends
    n_models: int            # registered in the fleet
    n_hot: int               # warm backends right now
    n_retired: int           # backends drained away (swaps + LRU evictions)
    #: fleet-wide resilience counters (sums across hot + retired backends)
    n_shed: int = 0
    n_deadline_expired: int = 0
    n_worker_restarts: int = 0
    #: model_id -> {backend: closed|open|half_open} for each hot backend
    breaker_state: dict = dataclasses.field(default_factory=dict)
    #: model_id -> the backend that served its most recent batch
    active_backend: dict = dataclasses.field(default_factory=dict)
    #: model_id -> ProgressiveScorer stats (streaming entries only):
    #: time_to_first_prediction_ms, blocks_evaluated, score_is_final, ...
    streaming: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "per_model": {k: v.as_dict() for k, v in self.per_model.items()},
            "fleet": self.fleet.as_dict(),
            "n_models": self.n_models,
            "n_hot": self.n_hot,
            "n_retired": self.n_retired,
            "n_shed": self.n_shed,
            "n_deadline_expired": self.n_deadline_expired,
            "n_worker_restarts": self.n_worker_restarts,
            "breaker_state": self.breaker_state,
            "active_backend": self.active_backend,
            "streaming": self.streaming,
        }


class _HotBackend:
    """A warm (version-pinned) MicroBatchEngine for one model."""

    def __init__(self, version: int, engine: MicroBatchEngine):
        self.version = version
        self.engine = engine


class FleetEngine:
    """Routes requests across every model a :class:`ModelRegistry` hosts."""

    def __init__(
        self,
        registry: ModelRegistry,
        *,
        backend: str | None = None,
        max_hot: int = 8,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        policy=None,
        faults=None,
        streaming: bool = False,
        early_exit=None,
    ):
        if max_hot < 1:
            raise ValueError("max_hot must be >= 1")
        self.registry = registry
        self.backend = backend
        self.max_hot = max_hot
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.policy = policy
        #: fleet-wide EarlyExitPolicy; applied per classification model,
        #: skipped for streaming entries (which exit via
        #: ProgressiveScorer.feed_until_confident) and regression tasks
        self.early_exit = early_exit
        #: serve partial sums from streaming entries (opt-in); with the
        #: default False a .toadpack entry waits for its last tree block
        #: before its backend is built, so every score is final
        self.streaming = streaming
        self._faults = faults
        self._hot: "collections.OrderedDict[str, _HotBackend]" = (
            collections.OrderedDict()
        )
        self._lock = threading.RLock()
        self._started = False
        self._retired_stats: list[EngineStats] = []
        self._retire_threads: list[threading.Thread] = []

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetEngine":
        with self._lock:
            self._started = True
            for hot in self._hot.values():
                hot.engine.start()
        return self

    def stop(self) -> "FleetEngine":
        """Stop every backend, draining all queues; join retire threads."""
        with self._lock:
            self._started = False
            hot, self._hot = list(self._hot.values()), collections.OrderedDict()
        for h in hot:
            h.engine.stop()
            self._retired_stats.append(h.engine.stats())
        self.drain()
        return self

    def drain(self) -> "FleetEngine":
        """Block until every retired backend has finished draining."""
        while True:
            with self._lock:
                threads, self._retire_threads = self._retire_threads, []
            if not threads:
                return self
            for t in threads:
                t.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -------------------------------------------------------------- routing
    def _retire(self, hot: _HotBackend) -> None:
        """Drain + stop a backend off the request path.

        ``stop()`` lets the worker drain every queued request first, so
        futures submitted before a swap/eviction complete against the model
        version they were routed to.
        """

        def _stop():
            hot.engine.stop()
            with self._lock:
                self._retired_stats.append(hot.engine.stats())

        t = threading.Thread(target=_stop, name="fleet-retire", daemon=True)
        with self._lock:
            # prune finished drains so a long-lived fleet with frequent
            # swaps/evictions doesn't accumulate dead Thread objects forever
            self._retire_threads = [
                x for x in self._retire_threads if x.is_alive()
            ]
            self._retire_threads.append(t)
        t.start()

    def _backend_for(self, model_id: str) -> MicroBatchEngine:
        entry = self.registry.get(model_id)  # raises UnknownModelError
        if entry.is_streaming and not self.streaming:
            # progressive serving was not opted into: block until the
            # entry's last tree block has landed so every score is final
            entry.model.wait_complete()
        with self._lock:
            hot = self._hot.get(model_id)
            if hot is not None and hot.version == entry.version:
                self._hot.move_to_end(model_id)
                return hot.engine
            # cold model, or the registry hot-swapped it: build the new
            # version's backend; the old one drains in the background
            from repro_torch.api.backends import resolve_backend

            model = entry.model
            primary = resolve_backend(
                self.backend, compressed=model.is_compressed, device=model.device
            ).name
            if entry.is_streaming and primary != "reference":
                # a progressive scorer serves every other name with its
                # torch traversal: name the backend it runs, not B1's
                primary = "packed"
            fallbacks = (
                fallback_chain(model, primary)
                if self.policy is not None and self.policy.fallback
                else ()
            )
            ee_adapter = None
            if (
                self.early_exit is not None
                and not entry.is_streaming
                and model.config.task != "regression"
            ):
                ee_adapter = EarlyExitPredictor(
                    model, self.early_exit, backend=self.backend
                )
            engine = MicroBatchEngine(
                ee_adapter if ee_adapter is not None
                else model.predictor(self.backend),
                int(model.forest.n_features),
                max_batch=self.max_batch,
                max_wait_ms=self.max_wait_ms,
                policy=self.policy,
                fallbacks=fallbacks,
                backend_name=primary,
                faults=self._faults,
                fault_tag=model_id,
                device=model.device,
                early_exit=ee_adapter,
            )
            if self._started:
                # warms every bucket: a primary that fails here raises out
                # of the route, before the LRU changes
                engine.start()
            if hot is not None:
                self._retire(hot)
            self._hot[model_id] = _HotBackend(entry.version, engine)
            self._hot.move_to_end(model_id)
            while len(self._hot) > self.max_hot:
                _, evicted = self._hot.popitem(last=False)
                self._retire(evicted)
            return engine

    def warm(self, *model_ids: str) -> "FleetEngine":
        """Pre-build (and, once started, pre-warm) backends for the given
        models."""
        for mid in model_ids or self.registry.ids():
            self._backend_for(mid)
        return self

    def submit(self, model_id: str, x_row):
        """Enqueue one (d,) request for ``model_id``; returns a Future."""
        return self._backend_for(model_id).submit(x_row)

    def predict(self, model_id: str, X) -> np.ndarray:
        """Direct batched call through ``model_id``'s predict path."""
        return self._backend_for(model_id).predict(X)

    def swap(self, model_id: str, path: str):
        """Registry hot-swap + immediate backend refresh for ``model_id``.

        Returns the new :class:`~repro_torch.fleet.registry.ModelEntry`.
        Old queued requests drain on the old version in the background; the
        new version serves as soon as this returns.
        """
        entry = self.registry.swap(model_id, path)
        self._backend_for(model_id)
        return entry

    def version(self, model_id: str) -> int:
        """The serving version currently routed to for ``model_id``."""
        return self.registry.get(model_id).version

    def wait_complete(self, *model_ids: str, timeout: float | None = None
                      ) -> bool:
        """Block until the given (default: all) streaming entries are final.

        No-op for classic entries.  Returns True iff every addressed
        streaming entry has consumed its last tree block — after which
        progressive responses equal the classic path's predictions.
        """
        ok = True
        for mid in model_ids or self.registry.ids():
            entry = self.registry.get(mid)
            if entry.is_streaming:
                ok &= entry.model.wait_complete(timeout)
        return ok

    # ----------------------------------------------------------------- stats
    def stats(self) -> FleetStats:
        with self._lock:
            per_model = {
                mid: hot.engine.stats() for mid, hot in self._hot.items()
            }
            retired = list(self._retired_stats)
        everything = list(per_model.values()) + retired
        streaming = {
            e.model_id: e.model.streaming_stats()
            for e in self.registry.entries()
            if e.is_streaming
        }
        return FleetStats(
            per_model=per_model,
            fleet=EngineStats.merge(everything),
            n_models=len(self.registry),
            n_hot=len(per_model),
            n_retired=len(retired),
            n_shed=sum(s.n_shed for s in everything),
            n_deadline_expired=sum(s.n_deadline_expired for s in everything),
            n_worker_restarts=sum(s.n_worker_restarts for s in everything),
            breaker_state={k: v.breaker_state for k, v in per_model.items()},
            active_backend={k: v.active_backend for k, v in per_model.items()},
            streaming=streaming,
        )
