"""Model-agnostic micro-batching serving engine + the GBDT specialization.

The engine owns a request queue and a worker thread.  Clients submit single
raw-feature rows; the worker drains up to ``max_batch`` requests per step
(waiting at most ``max_wait_ms`` for stragglers after the first arrival),
pads the batch to a power-of-two shape bucket, runs one prediction and
resolves the per-request futures.

The worker thread owns its CUDA calls: it selects the engine's device when
it starts, and again when its supervisor restarts it.
``MicroBatchEngine`` takes any ``(n, d) -> (n, C)`` function;
``GBDTEngine`` wires it to a :class:`~repro_torch.api.model.ToadModel`
through a registered predictor backend, or through an
:class:`EarlyExitPredictor` when given an early-exit policy.

**Resilience** (:mod:`repro_torch.api.resilience`): with a
:class:`~repro_torch.api.resilience.ResiliencePolicy` the engine bounds its
queue (full queue -> typed ``Overloaded`` at admission), enforces
per-request deadlines both at dequeue (expired requests complete with
``DeadlineExceeded`` without wasting a predict) and inside
``submit().result()``, retries failed batch predicts with deterministic
seeded backoff, and walks a **fallback chain** of degraded-but-correct
backends (``cuda -> packed -> reference``, all inside the <=1e-5 parity
contract) guarded by per-backend circuit breakers.  A supervisor catches
worker crashes, fails the in-flight futures with a typed
``WorkerCrashed`` error, and restarts the worker up to
``policy.restart_budget`` times.  The invariant either way: **every**
submitted future resolves with a result or a typed exception — ``stop()``
sweeps anything still queued.

The chain is an opt-in policy and never leaves the model's device: every
fallback runs where the primary runs (``packed`` is the plain PyTorch
traversal on the device's tensors, ``reference`` the dense forest
traversal), and each batch a fallback serves counts in
``EngineStats.n_fallback_batches``.  A fault that poisons the CUDA context
(an illegal address, say) fails the fallbacks on that device too, so the
batch fails with the error; the engine never carries on on the CPU.
Without a policy (or with ``fallback`` off) there is no chain at all.
Unlike the JAX package's engine, a primary that fails its warm-up in
``start()`` raises even when fallbacks exist: there is no degraded start.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import queue
import threading
import time

import numpy as np
import torch

from repro_torch import tracing
from repro_torch._device import host, resolve_device
from repro_torch.api.resilience import (
    BadRequest,
    CircuitBreaker,
    DeadlineExceeded,
    EngineError,
    EngineStopped,
    Overloaded,
    ResiliencePolicy,
    WorkerCrashed,
)

__all__ = [
    "DEGRADATION_ORDER",
    "EarlyExitPredictor",
    "EngineStats",
    "EngineStopped",
    "GBDTEngine",
    "MicroBatchEngine",
    "WORKER_STEPS",
    "fallback_chain",
]

#: the worker's steps a served batch, each an ``engine.<step>`` span
#: (``repro_torch.tracing``) under the batch's ``engine.batch`` span:
#: dequeue (the wait for the first request and the stragglers included),
#: stacking and padding the rows, the predict through the backend chain
#: (copies to and from the device included), resolving the futures
WORKER_STEPS = ("dequeue", "stack", "predict", "resolve")

#: backend names from most-accelerated to most-conservative; a fallback
#: chain is the suffix after the primary (see :func:`fallback_chain`)
DEGRADATION_ORDER = ("cuda", "packed", "reference")


def fallback_chain(model, primary: str) -> list:
    """``[(name, predict_fn), ...]`` for every backend less accelerated
    than ``primary`` in :data:`DEGRADATION_ORDER`.

    An unknown (custom) primary falls back through ``packed`` then
    ``reference``.  Each function builds its predictor through
    ``model.predictor(name)`` at its first call (the model caches it per
    backend), so an engine that is never faulted never builds its
    fallbacks.  Every fallback runs on the model's device.
    """
    order = DEGRADATION_ORDER
    start = order.index(primary) + 1 if primary in order else 1
    return [(name, _lazy_predictor(model, name)) for name in order[start:]]


def _lazy_predictor(model, name: str):
    def predict(rows):
        return model.predictor(name)(rows)

    return predict


class EarlyExitPredictor:
    """A ``(n, d) -> (n, C)`` adapter that realizes early exits per backend.

    Wraps a fitted :class:`~repro_torch.api.model.ToadModel` and an
    :class:`~repro_torch.gbdt.early_exit.EarlyExitPolicy`; the engine plugs
    it in as its predict function and reads its trees-evaluated counters
    into ``EngineStats.mean_trees_evaluated``.  Per backend:

    * ``cuda`` — mode ``kernel``: the CUDA early-exit kernel
      (:func:`repro_torch.kernels.ops.predict_packed_model_early_exit`), in
      place of the JAX package's ``pallas`` mode;
    * ``packed`` — mode ``packed``: the kernel's plain version
      (:func:`repro_torch.kernels.ref.packed_predict_early_exit_ref`) on
      the same tables.  The JAX package's ``staged`` mode, which exists to
      spare XLA a recompile per row count, has no counterpart here;
    * ``reference`` — mode ``reference``: the row-level numpy evaluator
      (:func:`repro_torch.gbdt.early_exit.predict_early_exit`).

    A never-exit policy (ε=∞), or a model without trees, is mode ``full``:
    the model's plain predictor, bit-identical to serving without early
    exit.  Exited rows return partial sums — the full ensemble's label, not
    its score.  The engine pads batches to shape buckets, so padded rows
    count toward ``mean_trees_evaluated`` like real ones.
    """

    def __init__(self, model, policy, backend: str | None = None):
        from repro_torch.api.backends import resolve_backend
        from repro_torch.core.treeorder import remaining_mass

        if model.config.task == "regression":
            raise ValueError(
                "early exit needs a discrete decision to protect; "
                "regression scores never become margin-final"
            )
        self.model = model
        self.policy = policy
        self.backend_name = resolve_backend(
            backend, compressed=model.is_compressed, device=model.device).name
        self.n_trees = int(model.forest.n_trees)
        self.C = int(model.forest.n_ensembles)
        self._t_eff = (self.n_trees if policy.max_trees is None
                       else min(int(policy.max_trees), self.n_trees))
        self._lock = threading.Lock()
        self._rows = 0
        #: trees evaluated, summed: a float on the host, plus (kernel and
        #: packed modes) a tensor on the device read back only by
        #: mean_trees_evaluated()
        self._trees = 0.0
        self._trees_dev = None

        if policy.never_exits or self.n_trees == 0:
            self._mode = "full"
            self._full = model.predictor(backend)
            return
        self._bound = remaining_mass(model.forest)
        self._slack = policy.slack(self.C)
        if self.backend_name == "reference":
            self._mode = "reference"
            return
        if not model.is_compressed:
            model.compress()
        self._mode = "kernel" if self.backend_name == "cuda" else "packed"
        self._init_packed()

    # -------------------------------------------------------------- modes
    def _init_packed(self):
        """The packed arrays, cut to the ``max_trees`` prefix, and the exit
        tables on the model's device, made once for every batch."""
        from repro_torch.kernels.predict import device_exit_tables

        dev = self.model.device_packed()
        T = self._t_eff
        if T < self.n_trees:  # max_trees cap: serve the prefix
            dev = dataclasses.replace(dev, words=dev.words[:T], leaf_ref=dev.leaf_ref[:T])
        self._packed = dev
        self._tables = device_exit_tables(
            self._bound[: T + 1], self._slack, n_trees=T, n_ensembles=self.C,
            min_trees=self.policy.min_trees, device=dev.device)

    def _plain(self, x: torch.Tensor):
        """The early-exit kernel's plain version on the same tables."""
        from repro_torch.kernels.predict import tree_block_for
        from repro_torch.kernels.ref import packed_predict_early_exit_ref

        scores, exit_at = packed_predict_early_exit_ref(
            x, *self._packed.arrays(), *self._tables, **self._packed.meta(),
            tree_block=tree_block_for(self.C), guard=float(np.float32(self.policy.guard)))
        return scores, exit_at.clamp(max=self._t_eff)

    # --------------------------------------------------------------- call
    def __call__(self, rows):
        """(n, d) rows (host or on the model's device) -> (n, C) scores; a
        tensor on the model's device in every mode but ``reference``."""
        from repro_torch.kernels.ops import as_rows

        x = as_rows(rows, self.model.device)
        n = x.shape[0]
        if self._mode == "full":
            out = self._full(x)
            self._account(n, float(n * self.n_trees))
            return out
        if self._mode == "reference":
            from repro_torch.gbdt.early_exit import predict_early_exit
            from repro_torch.kernels.predict import TREE_BLOCK

            res = predict_early_exit(
                self.model.forest, x, self.policy, bound=self._bound,
                check_every=TREE_BLOCK)
            self._account(n, float(np.sum(res.trees_evaluated)))
            return res.scores
        if self._mode == "kernel":
            from repro_torch.kernels.ops import predict_packed_model_early_exit

            scores, trees, _ = predict_packed_model_early_exit(
                self._packed, x, tables=self._tables, guard=self.policy.guard,
                device=self.model.device)
        else:
            scores, trees = self._plain(x)
        # summed on the device: the batch's one read-back stays the scores
        self._account(n, trees.sum(dtype=torch.int64))
        return scores

    @property
    def mode(self) -> str:
        """The serving path in use: full | reference | kernel | packed."""
        return self._mode

    # -------------------------------------------------------------- stats
    def _account(self, n: int, trees_total) -> None:
        with self._lock:
            self._rows += n
            if isinstance(trees_total, torch.Tensor):
                self._trees_dev = (trees_total if self._trees_dev is None
                                   else self._trees_dev + trees_total)
            else:
                self._trees += trees_total

    def reset(self) -> None:
        """Zero the counters (the engine calls this after warm-up)."""
        with self._lock:
            self._rows = 0
            self._trees = 0.0
            self._trees_dev = None

    def mean_trees_evaluated(self) -> float:
        with self._lock:
            trees = self._trees
            if self._trees_dev is not None:
                trees += float(self._trees_dev)  # the one read-back
            return trees / self._rows if self._rows else 0.0

    def rows_counted(self) -> int:
        """Rows accounted so far."""
        with self._lock:
            return self._rows


class _EngineFuture(concurrent.futures.Future):
    """A Future that enforces the request deadline inside ``result()``."""

    _deadline_t: float | None = None

    def result(self, timeout=None):
        if self._deadline_t is not None:
            remaining = self._deadline_t - time.perf_counter()
            if timeout is None or remaining < timeout:
                try:
                    return super().result(timeout=max(remaining, 0.0))
                except concurrent.futures.TimeoutError:
                    raise DeadlineExceeded(
                        "request deadline exceeded while waiting for the "
                        "result"
                    ) from None
        return super().result(timeout)


@dataclasses.dataclass
class EngineStats:
    n_requests: int
    n_batches: int
    wall_s: float
    req_per_s: float
    mean_batch: float
    latency_mean_ms: float
    latency_p50_ms: float
    latency_p95_ms: float
    #: requests waiting in the queue at the moment stats() was taken
    queue_depth: int = 0
    #: per shape-bucket occupancy: {bucket_size: {"batches": n, "mean_fill":
    #: real_rows / (n * bucket_size)}}
    batch_occupancy: dict = dataclasses.field(default_factory=dict)
    #: admissions rejected with Overloaded (bounded queue full)
    n_shed: int = 0
    #: requests that expired in the queue (DeadlineExceeded at dequeue)
    n_deadline_expired: int = 0
    #: worker restarts after a crash (supervisor)
    n_worker_restarts: int = 0
    #: batch predict retries (before backend fallback / failure)
    n_predict_retries: int = 0
    #: batches served by a non-primary backend (degraded but correct)
    n_fallback_batches: int = 0
    #: per-backend circuit-breaker state: {backend: closed|open|half_open}
    breaker_state: dict = dataclasses.field(default_factory=dict)
    #: the backend that served the most recent batch
    active_backend: str = ""
    #: mean trees evaluated per row under an early-exit policy (0.0 when
    #: early exit is off; includes batch-padding rows)
    mean_trees_evaluated: float = 0.0
    #: rows the early-exit adapter accounted (the merge weight; counts
    #: direct ``predict()`` traffic that never enters the request queue)
    n_early_exit_rows: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def merge(parts: "list[EngineStats]") -> "EngineStats":
        """Aggregate across engines (fleet-wide view).

        Counts and occupancy sum exactly; wall clock is the max (engines run
        concurrently); latency mean and percentiles are request-weighted
        averages of the per-engine values — exact for the mean, an
        operational summary for p50/p95.  Per-backend breaker state and the
        active backend are per-engine facts and stay empty on the merged
        view.
        """
        parts = [p for p in parts if p is not None]
        if not parts:
            return EngineStats(0, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
        n = sum(p.n_requests for p in parts)
        ee_parts = [p for p in parts if p.n_early_exit_rows > 0]
        ee_n = sum(p.n_early_exit_rows for p in ee_parts)
        wall = max(p.wall_s for p in parts)

        def wavg(f):
            return sum(f(p) * p.n_requests for p in parts) / n if n else 0.0

        occupancy: dict = {}
        for p in parts:
            for bucket, o in p.batch_occupancy.items():
                cur = occupancy.setdefault(bucket, {"batches": 0, "mean_fill": 0.0})
                tot = cur["batches"] + o["batches"]
                if tot:
                    cur["mean_fill"] = (
                        cur["mean_fill"] * cur["batches"]
                        + o["mean_fill"] * o["batches"]
                    ) / tot
                cur["batches"] = tot
        return EngineStats(
            n_requests=n,
            n_batches=sum(p.n_batches for p in parts),
            wall_s=wall,
            req_per_s=n / max(wall, 1e-9),
            mean_batch=wavg(lambda p: p.mean_batch),
            latency_mean_ms=wavg(lambda p: p.latency_mean_ms),
            latency_p50_ms=wavg(lambda p: p.latency_p50_ms),
            latency_p95_ms=wavg(lambda p: p.latency_p95_ms),
            queue_depth=sum(p.queue_depth for p in parts),
            batch_occupancy=occupancy,
            n_shed=sum(p.n_shed for p in parts),
            n_deadline_expired=sum(p.n_deadline_expired for p in parts),
            n_worker_restarts=sum(p.n_worker_restarts for p in parts),
            n_predict_retries=sum(p.n_predict_retries for p in parts),
            n_fallback_batches=sum(p.n_fallback_batches for p in parts),
            # row-weighted over the engines actually running early exit
            mean_trees_evaluated=(
                sum(p.mean_trees_evaluated * p.n_early_exit_rows
                    for p in ee_parts)
                / ee_n if ee_n else 0.0
            ),
            n_early_exit_rows=ee_n,
        )


class MicroBatchEngine:
    """Batches single-row requests through one predict function."""

    def __init__(
        self,
        predict_fn,
        n_features: int,
        *,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        policy: ResiliencePolicy | None = None,
        fallbacks=(),
        backend_name: str = "primary",
        faults=None,
        fault_tag: str = "",
        device="cuda",
        early_exit: EarlyExitPredictor | None = None,
    ):
        self._predict = predict_fn
        #: the EarlyExitPredictor serving as predict_fn, if any: read for
        #: EngineStats.mean_trees_evaluated and reset after warm-up
        self._early_exit = early_exit
        self.n_features = n_features
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.device = resolve_device(device)
        self.policy = policy if policy is not None else ResiliencePolicy()
        self._deadline_s = self.policy.deadline_ms / 1e3
        self._chain: list = [(backend_name, predict_fn)] + list(fallbacks)
        self._breakers = [
            CircuitBreaker(self.policy.breaker_threshold,
                           self.policy.breaker_cooldown_ms / 1e3)
            for _ in self._chain
        ]
        self._faults = faults
        self._fault_tag = fault_tag
        self._queue: queue.Queue = queue.Queue(
            maxsize=max(0, self.policy.max_queue_depth)
        )
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        #: serializes submit()'s stopped-check-then-enqueue against stop()'s
        #: flag-set-then-drain, so no request lands in a queue nobody drains
        self._admission_lock = threading.Lock()
        self._stopping = False
        self._crashed = False
        self._inflight: list = []
        self._latencies: list[float] = []
        self._batch_sizes: list[int] = []
        self._bucket_hits: dict[int, list[int]] = {}  # bucket -> [batches, rows]
        self._t_start = 0.0
        self._t_busy_end = 0.0
        self._n_shed = 0
        self._n_deadline = 0
        self._n_restarts = 0
        self._n_crashes = 0
        self._n_retries = 0
        self._n_fallback = 0
        self._active_idx = 0
        self._backoff_rng = np.random.default_rng(self.policy.seed)

    # ---------------------------------------------------------------- client
    def submit(self, x_row) -> concurrent.futures.Future:
        """Enqueue one (d,) raw-feature request; resolves to a (C,) score.

        Typed failures: :class:`EngineStopped` when the engine is not
        started / stopped / crashed out of its restart budget;
        :class:`Overloaded` when the bounded queue is full; a returned
        future carrying :class:`BadRequest` (a ``ValueError``) when the row
        cannot be shaped to the model's feature width.
        """
        t_in = time.perf_counter()
        fut = _EngineFuture()
        if self._deadline_s:
            fut._deadline_t = t_in + self._deadline_s
        try:
            row = np.asarray(x_row, dtype=np.float32).reshape(self.n_features)
        except Exception as exc:
            # resolve, don't raise: the malformed row must never reach the
            # worker (np.stack would fail the whole batch) and async
            # clients expect the error on the future they hold
            fut.set_exception(BadRequest(
                f"cannot shape request of size {np.asarray(x_row).size} to "
                f"({self.n_features},): {exc}"
            ))
            return fut
        with self._admission_lock:
            if self._worker is None or self._stopping:
                raise EngineStopped(
                    "engine not started or stopped" if not self._crashed else
                    "engine worker crashed out of its restart budget"
                )
            try:
                self._queue.put_nowait((row, t_in, fut))
            except queue.Full:
                self._n_shed += 1
                fut.set_exception(Overloaded(
                    f"queue full ({self.policy.max_queue_depth} deep); "
                    f"request shed at admission"
                ))
        return fut

    def predict(self, X) -> np.ndarray:
        """Direct batched call through the same predict path (no queue)."""
        return host(self._predict(np.asarray(X, dtype=np.float32)))

    # ---------------------------------------------------------------- worker
    def start(self) -> "MicroBatchEngine":
        if self._worker is not None:
            return self
        self._stop.clear()
        self._stopping = False
        self._crashed = False
        self._latencies.clear()
        self._batch_sizes.clear()
        self._bucket_hits.clear()
        self._n_shed = self._n_deadline = 0
        self._n_restarts = self._n_crashes = 0
        self._n_retries = self._n_fallback = 0
        self._active_idx = 0
        # warm the predictor at every bucket shape, so the first requests
        # pay no kernel build and the stats clock starts after it.  A
        # primary that fails here raises, fallbacks or not: the chain takes
        # over only from a primary that has built and served, so a kernel
        # that does not build or launch is never hidden behind it
        for b in self._buckets():
            host(self._predict(np.zeros((b, self.n_features), np.float32)))
        if self._early_exit is not None:
            self._early_exit.reset()  # warm-up rows must not skew the mean
        self._t_start = time.perf_counter()
        self._worker = threading.Thread(
            target=self._supervise, name="gbdt-engine", daemon=True
        )
        self._worker.start()
        return self

    def stop(self) -> "MicroBatchEngine":
        """Stop the worker after draining the queue.

        Every future ever returned by ``submit()`` is resolved when this
        returns — drained requests with results, anything left behind by a
        crashed worker with a typed error — and later ``submit()`` calls
        raise :class:`EngineStopped`.
        """
        if self._worker is None:
            return self
        with self._admission_lock:
            self._stopping = True  # no admissions from here on
        self._stop.set()
        self._worker.join()
        self._worker = None
        # the worker drains the queue before it exits; anything still queued
        # means it crashed out: resolve those futures, never strand them
        self._fail_pending(EngineStopped("engine stopped"))
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _fail_pending(self, err: Exception) -> int:
        n = 0
        while True:
            try:
                _, _, fut = self._queue.get_nowait()
            except queue.Empty:
                return n
            if not fut.done():
                fut.set_exception(err)
                n += 1

    def _buckets(self):
        b, out = 1, []
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return out

    def _bucket(self, n: int) -> int:
        for b in self._buckets():
            if n <= b:
                return b
        return self.max_batch

    def _supervise(self):
        """Run the worker loop, restarting it after crashes.

        A crash (an exception escaping :meth:`_run`, e.g. an injected
        worker fault) fails the in-flight futures with a typed
        :class:`WorkerCrashed` and restarts the loop, up to
        ``policy.restart_budget`` restarts; past the budget the engine
        fails every queued future and refuses new admissions.  The loop
        selects the engine's device each time it (re)starts.
        """
        while True:
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                self._run()
                return  # clean stop
            except Exception as exc:  # worker crash
                err = WorkerCrashed(f"engine worker crashed: {exc!r}")
                err.__cause__ = exc
                inflight, self._inflight = self._inflight, []
                for _, _, fut in inflight:
                    if not fut.done():
                        fut.set_exception(err)
                self._n_crashes += 1
                if (
                    self._n_crashes > self.policy.restart_budget
                    or self._stop.is_set()
                ):
                    with self._admission_lock:
                        self._crashed = True
                        self._stopping = True
                    self._fail_pending(err)
                    return
                self._n_restarts += 1

    def _run(self):
        """Serve batches until stopped; each served batch is an
        ``engine.batch`` span with a child span a step (:data:`WORKER_STEPS`)."""
        while not (self._stop.is_set() and self._queue.empty()):
            t0 = tracing.clock_ns()
            batch = self._next_batch()
            if not batch:
                continue
            with tracing.span("engine.batch", requests=len(batch)).since(t0):
                with tracing.span("engine.dequeue").since(t0):
                    pass  # the dequeue ran before the batch was known: a span from t0
                with tracing.span("engine.stack"):
                    rows, n, padded = self._stack(batch)
                try:
                    with tracing.span("engine.predict"):
                        scores = self._predict_batch(rows)[:n]
                except Exception as exc:
                    # never strand clients: fail this batch's futures and keep
                    # the worker alive for the rest of the queue
                    for _, _, fut in batch:
                        if not fut.done():
                            fut.set_exception(exc)
                    self._inflight = []
                    continue
                with tracing.span("engine.resolve"):
                    self._resolve(batch, scores, n, padded)

    def _next_batch(self) -> list:
        """Dequeue the next batch: the first request, then stragglers for up
        to ``max_wait_ms``; fire the ``worker`` fault point with the batch
        in hand and drop the requests whose deadline passed in the queue.
        Empty when nothing arrived or nothing is left alive."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        wait_until = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = wait_until - time.perf_counter()
            if remaining <= 0 and self._queue.empty():
                break
            try:
                batch.append(self._queue.get(timeout=max(remaining, 0.0)))
            except queue.Empty:
                break
        self._inflight = batch
        if self._faults is not None:
            # the injected-worker-crash point: raises with the batch in
            # hand, exercising the supervisor's in-flight failing
            self._faults.fire("worker", model=self._fault_tag)
        if self._deadline_s:
            now = time.perf_counter()
            live = []
            for item in batch:
                if now - item[1] > self._deadline_s:
                    self._n_deadline += 1
                    if not item[2].done():
                        item[2].set_exception(DeadlineExceeded(
                            "request expired in the queue before a "
                            "prediction was attempted"
                        ))
                else:
                    live.append(item)
            batch = live
            self._inflight = live
        return batch

    def _stack(self, batch: list) -> tuple[np.ndarray, int, int]:
        """The batch's rows, zero-padded to their shape bucket."""
        rows = np.stack([b[0] for b in batch])
        n = rows.shape[0]
        padded = self._bucket(n)
        if padded != n:
            rows = np.concatenate(
                [rows, np.zeros((padded - n, self.n_features), np.float32)]
            )
        return rows, n, padded

    def _resolve(self, batch: list, scores: np.ndarray, n: int, padded: int) -> None:
        """Record the batch's stats and resolve its futures."""
        done = time.perf_counter()
        self._batch_sizes.append(n)
        hit = self._bucket_hits.setdefault(padded, [0, 0])
        hit[0] += 1
        hit[1] += n
        for (_, t_in, fut), s in zip(batch, scores):
            self._latencies.append(done - t_in)
            if not fut.done():
                fut.set_result(s)
        self._inflight = []
        self._t_busy_end = done

    def _predict_batch(self, rows: np.ndarray) -> np.ndarray:
        """One batch through the backend chain: retries with deterministic
        backoff on the active backend, then on to the next breaker-allowed
        fallback.  A success closes the backend's breaker; exhausting a
        backend's retries records one consecutive failure toward opening
        it."""
        last_exc: Exception | None = None

        def attempt(idx: int) -> np.ndarray | None:
            nonlocal last_exc
            name, fn = self._chain[idx]
            for retry in range(self.policy.max_retries + 1):
                try:
                    if self._faults is not None:
                        self._faults.fire(
                            "predict", model=self._fault_tag, backend=name
                        )
                    out = host(fn(rows))
                except Exception as exc:
                    last_exc = exc
                    if retry < self.policy.max_retries:
                        self._n_retries += 1
                        time.sleep(self._backoff_s(retry))
                    continue
                self._breakers[idx].record_success()
                self._active_idx = idx
                if idx > 0:
                    self._n_fallback += 1
                return out
            self._breakers[idx].record_failure()
            return None

        attempted = False
        for idx in range(len(self._chain)):
            if not self._breakers[idx].allow():
                continue
            attempted = True
            out = attempt(idx)
            if out is not None:
                return out
        if not attempted:
            # every breaker is open mid-cooldown; degraded-but-serving
            # beats down, so bypass the breaker on the most-conservative
            # backend rather than failing the batch unattempted
            out = attempt(len(self._chain) - 1)
            if out is not None:
                return out
        raise last_exc if last_exc is not None else EngineError(
            "no backend available (all circuit breakers open)"
        )

    def _backoff_s(self, retry: int) -> float:
        p = self.policy
        step = p.backoff_base_ms * p.backoff_mult**retry
        jitter = 1.0 + p.backoff_jitter * float(self._backoff_rng.random())
        return (step * jitter) / 1e3

    # ----------------------------------------------------------------- stats
    def stats(self) -> EngineStats:
        lat = np.asarray(self._latencies, dtype=np.float64)
        n = int(lat.size)
        wall = max(self._t_busy_end - self._t_start, 1e-9)
        return EngineStats(
            n_requests=n,
            n_batches=len(self._batch_sizes),
            wall_s=wall,
            req_per_s=n / wall,
            mean_batch=float(np.mean(self._batch_sizes)) if self._batch_sizes else 0.0,
            latency_mean_ms=float(lat.mean() * 1e3) if n else 0.0,
            latency_p50_ms=float(np.percentile(lat, 50) * 1e3) if n else 0.0,
            latency_p95_ms=float(np.percentile(lat, 95) * 1e3) if n else 0.0,
            queue_depth=self._queue.qsize(),
            batch_occupancy={
                bucket: {
                    "batches": batches,
                    "mean_fill": rows / (batches * bucket),
                }
                for bucket, (batches, rows) in sorted(self._bucket_hits.items())
            },
            n_shed=self._n_shed,
            n_deadline_expired=self._n_deadline,
            n_worker_restarts=self._n_restarts,
            n_predict_retries=self._n_retries,
            n_fallback_batches=self._n_fallback,
            breaker_state={
                name: br.state
                for (name, _), br in zip(self._chain, self._breakers)
            },
            active_backend=self._chain[self._active_idx][0],
            mean_trees_evaluated=(
                self._early_exit.mean_trees_evaluated()
                if self._early_exit is not None else 0.0
            ),
            n_early_exit_rows=(
                self._early_exit.rows_counted()
                if self._early_exit is not None else 0
            ),
        )


class GBDTEngine(MicroBatchEngine):
    """A MicroBatchEngine serving a ToadModel through a named backend.

    ``model`` may also be a path to a prebuilt ``.toad`` artifact, loaded
    onto ``device`` through ``load_checked``.  A model object is served on
    its own device.

    With a :class:`~repro_torch.api.resilience.ResiliencePolicy` whose
    ``fallback`` is set, the engine builds the degraded-backend chain from
    the resolved primary (:func:`fallback_chain`): a ``cuda`` engine falls
    back to ``packed`` then ``reference`` on the same device when its
    breaker opens — slower, but inside the <=1e-5 parity contract.

    ``early_exit`` takes an :class:`~repro_torch.gbdt.early_exit
    .EarlyExitPolicy`: the primary predict function becomes an
    :class:`EarlyExitPredictor` (same labels, partial scores on exited
    rows) and ``stats().mean_trees_evaluated`` reports the per-row average
    prefix length.  The fallbacks stay full-evaluation predictors.
    """

    def __init__(
        self,
        model,
        *,
        backend: str | None = None,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        policy: ResiliencePolicy | None = None,
        faults=None,
        fault_tag: str = "",
        device="cuda",
        early_exit=None,
    ):
        if isinstance(model, (str, os.PathLike)):
            from repro_torch.api.artifact import load_checked

            model = load_checked(model, device=device).model
        from repro_torch.api.backends import resolve_backend

        ee_adapter = None
        if early_exit is not None:
            ee_adapter = EarlyExitPredictor(model, early_exit, backend=backend)
            fn = ee_adapter
        else:
            fn = model.predictor(backend)
        primary = resolve_backend(
            backend, compressed=model.is_compressed, device=model.device).name
        # fallbacks stay full-evaluation predictors: degraded but correct,
        # they just stop saving trees
        fallbacks = (
            fallback_chain(model, primary)
            if policy is not None and policy.fallback
            else ()
        )
        super().__init__(
            fn,
            int(model.forest.n_features),
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            policy=policy,
            fallbacks=fallbacks,
            backend_name=primary,
            faults=faults,
            fault_tag=fault_tag,
            device=model.device,
            early_exit=ee_adapter,
        )
        self.model = model
        self.early_exit = early_exit
        self.backend = primary
