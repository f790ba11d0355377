"""Model-agnostic micro-batching serving engine + the GBDT specialization.

The engine owns a request queue and a worker thread.  Clients submit single
raw-feature rows; the worker drains up to ``max_batch`` requests per step
(waiting at most ``max_wait_ms`` for stragglers after the first arrival),
pads the batch to a power-of-two shape bucket, runs one prediction and
resolves the per-request futures.  ``stop()`` drains the queue, so every
submitted future resolves with a result or an exception.

The worker thread owns its CUDA calls: it selects the engine's device when
it starts.  ``MicroBatchEngine`` takes any ``(n, d) -> (n, C)`` function;
``GBDTEngine`` wires it to a :class:`~repro_torch.api.model.ToadModel`
through a registered predictor backend, or through an
:class:`EarlyExitPredictor` when given an early-exit policy.

Not here yet: the JAX package's resilience policy (bounded queue,
deadlines, retries, circuit breakers, fallback chains, supervised
restarts), fault injection and ``EngineStats.merge`` (fleet serving).
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

from repro_torch._device import host, resolve_device


class EngineStopped(RuntimeError):
    """The engine is not started, or was stopped."""


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
    #: mean trees evaluated per row under an early-exit policy (0.0 when
    #: early exit is off; includes batch-padding rows)
    mean_trees_evaluated: float = 0.0
    #: rows the early-exit adapter accounted (counts direct ``predict()``
    #: traffic that never enters the request queue)
    n_early_exit_rows: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class MicroBatchEngine:
    """Batches single-row requests through one predict function."""

    def __init__(
        self,
        predict_fn,
        n_features: int,
        *,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
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
        self._queue: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        #: serializes submit()'s stopped-check-then-enqueue against stop()'s
        #: flag-set-then-drain, so no request lands in a queue nobody drains
        self._admission_lock = threading.Lock()
        self._stopping = False
        self._latencies: list[float] = []
        self._batch_sizes: list[int] = []
        self._bucket_hits: dict[int, list[int]] = {}  # bucket -> [batches, rows]
        self._t_start = 0.0
        self._t_busy_end = 0.0

    # ---------------------------------------------------------------- client
    def submit(self, x_row) -> concurrent.futures.Future:
        """Enqueue one (d,) raw-feature request; resolves to a (C,) score.

        Raises :class:`EngineStopped` when the engine is not running; a row
        that cannot be shaped to the model's width resolves its future with
        a ``ValueError``.
        """
        t_in = time.perf_counter()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        try:
            row = np.asarray(x_row, dtype=np.float32).reshape(self.n_features)
        except ValueError as exc:
            # resolve, don't raise: async clients expect the error on the
            # future they hold, and the row must never reach the worker
            fut.set_exception(ValueError(
                f"cannot shape request of size {np.asarray(x_row).size} to "
                f"({self.n_features},): {exc}"
            ))
            return fut
        with self._admission_lock:
            if self._worker is None or self._stopping:
                raise EngineStopped("engine not started or stopped")
            self._queue.put((row, t_in, fut))
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
        self._latencies.clear()
        self._batch_sizes.clear()
        self._bucket_hits.clear()
        # warm the predictor at every bucket shape, so the first requests
        # pay no kernel build and the stats clock starts after it
        for b in self._buckets():
            host(self._predict(np.zeros((b, self.n_features), np.float32)))
        if self._early_exit is not None:
            self._early_exit.reset()  # warm-up rows must not skew the mean
        self._t_start = time.perf_counter()
        self._worker = threading.Thread(target=self._run, name="gbdt-engine", daemon=True)
        self._worker.start()
        return self

    def stop(self) -> "MicroBatchEngine":
        """Stop the worker after draining the queue; every future returned by
        ``submit()`` is resolved when this returns."""
        if self._worker is None:
            return self
        with self._admission_lock:
            self._stopping = True  # no admissions from here on
        self._stop.set()
        self._worker.join()
        self._worker = None
        # the worker drains the queue before it exits; should it have died,
        # resolve what is left instead of stranding clients
        while True:
            try:
                _, _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(EngineStopped("engine stopped"))
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

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

    def _run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not (self._stop.is_set() and self._queue.empty()):
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
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
            rows = np.stack([b[0] for b in batch])
            n = rows.shape[0]
            padded = self._bucket(n)
            if padded != n:
                rows = np.concatenate(
                    [rows, np.zeros((padded - n, self.n_features), np.float32)]
                )
            try:
                scores = host(self._predict(rows))[:n]
            except Exception as exc:  # the worker must outlive a failed batch
                # never strand clients: fail this batch's futures and keep
                # serving the rest of the queue
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
                continue
            done = time.perf_counter()
            self._batch_sizes.append(n)
            hit = self._bucket_hits.setdefault(padded, [0, 0])
            hit[0] += 1
            hit[1] += n
            for (_, t_in, fut), s in zip(batch, scores):
                self._latencies.append(done - t_in)
                if not fut.done():
                    fut.set_result(s)
            self._t_busy_end = done

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

    ``early_exit`` takes an :class:`~repro_torch.gbdt.early_exit
    .EarlyExitPolicy`: the predict function becomes an
    :class:`EarlyExitPredictor` (same labels, partial scores on exited
    rows) and ``stats().mean_trees_evaluated`` reports the per-row average
    prefix length.
    """

    def __init__(
        self,
        model,
        *,
        backend: str | None = None,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
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
        super().__init__(
            fn,
            int(model.forest.n_features),
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            device=model.device,
            early_exit=ee_adapter,
        )
        self.model = model
        self.early_exit = early_exit
        self.backend = resolve_backend(
            backend, compressed=model.is_compressed, device=model.device).name
