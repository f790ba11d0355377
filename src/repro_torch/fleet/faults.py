"""Deterministic fault injection for the serving stack (a copy of
``repro.fleet.faults``, numpy only).

Every recovery path in the resilience layer — supervisor restart, breaker
fallback, deadline expiry, load shedding, failed-swap rollback — must be
*exercised*, not trusted.  This module injects faults at the three seams
the engines expose behind a test-only hook (``faults=`` constructor
parameter, ``None`` in production, so the unfaulted hot path pays one
``is not None`` check per batch):

* ``predict`` — fired inside ``MicroBatchEngine._predict_batch`` before
  each backend call, tagged with the backend name: a raise here models a
  kernel fault and drives retry/breaker/fallback; a sleep models a slow
  predict blowing the deadline.
* ``worker`` — fired in the worker loop with a batch in hand: a raise
  models worker death and drives the supervisor (fail in-flight, restart
  up to the budget).
* ``admit`` — fired inside the fleet registry's admission: a raise models
  an artifact load error mid-``swap`` and must leave the old version
  serving (:class:`~repro_torch.fleet.registry.ModelRegistry`).

A :class:`FaultPlan` is a *schedule*: each :class:`Fault` names its
injection point, optional model/backend filters, and when to fire — at
explicit occurrence indices (``at``), from an occurrence onward
(``after``), or probabilistically (``p``) from a generator seeded by the
plan's ``seed``.  Same plan, same traffic order -> same faults, so chaos
tests are reproducible in CI.

:class:`FutureLedger` is the companion leak checker: track every future a
test submits, then ``assert_all_resolved()`` — the tentpole invariant is
that **no** injected fault ever strands a future.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time

import numpy as np

__all__ = ["Fault", "FaultPlan", "FutureLedger", "InjectedFault"]

#: the injection points the engines expose (see module docstring)
FAULT_POINTS = ("predict", "worker", "admit")


class InjectedFault(RuntimeError):
    """The error a ``raise``-action fault injects (never raised by real
    serving code — seeing it outside a chaos test means a hook leaked)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injectable fault in a :class:`FaultPlan` schedule.

    Firing rule, evaluated per matching occurrence of ``point`` (occurrence
    indices are 0-based and counted per ``(point, model)``):

    * ``at`` non-empty: fire exactly at those occurrence indices;
    * else ``p`` > 0: fire with probability ``p`` (seeded draw);
    * else: fire at every occurrence >= ``after``.

    ``count`` caps total fires (0 = uncapped).  ``action`` is ``"raise"``
    (raise :class:`InjectedFault`) or ``"sleep"`` (block ``sleep_s``
    seconds — a slow predict, not a failed one).
    """

    point: str
    at: tuple = ()
    after: int = 0
    count: int = 0
    p: float = 0.0
    model: str | None = None     # None = any model
    backend: str | None = None   # None = any backend
    action: str = "raise"
    sleep_s: float = 0.0
    message: str = "injected fault"

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; valid: {FAULT_POINTS}"
            )
        if self.action not in ("raise", "sleep"):
            raise ValueError(f"unknown fault action {self.action!r}")


class FaultPlan:
    """A seeded, deterministic schedule of :class:`Fault`\\ s.

    Thread-safe: occurrence counting and fire decisions happen under one
    lock; sleeps happen outside it so a slow-predict fault doesn't stall
    other engines' fire checks.  ``plan.log`` records every fire as
    ``(point, model, backend, occurrence, action)`` for test assertions.
    """

    def __init__(self, faults, seed: int = 0):
        self.faults = list(faults)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._occurrences: dict = {}   # (point, model) -> count
        self._fires: dict = {}         # fault index -> count
        self.log: list = []

    def fire(self, point: str, *, model: str = "", backend: str = "") -> None:
        """Called by the engines at each injection point; raises or sleeps
        per the schedule, no-ops otherwise."""
        sleep_s = 0.0
        raises: Fault | None = None
        with self._lock:
            key = (point, model)
            occ = self._occurrences.get(key, 0)
            self._occurrences[key] = occ + 1
            for idx, f in enumerate(self.faults):
                if f.point != point:
                    continue
                if f.model is not None and f.model != model:
                    continue
                if f.backend is not None and f.backend != backend:
                    continue
                if f.count and self._fires.get(idx, 0) >= f.count:
                    continue
                if f.at:
                    hit = occ in f.at
                elif f.p > 0.0:
                    hit = float(self._rng.random()) < f.p
                else:
                    hit = occ >= f.after
                if not hit:
                    continue
                self._fires[idx] = self._fires.get(idx, 0) + 1
                self.log.append((point, model, backend, occ, f.action))
                if f.action == "sleep":
                    sleep_s = max(sleep_s, f.sleep_s)
                else:
                    raises = f
                    break
        if sleep_s:
            time.sleep(sleep_s)
        if raises is not None:
            raise InjectedFault(
                f"{raises.message} [{point} model={model!r} "
                f"backend={backend!r} occurrence={occ}]"
            )

    def n_fired(self, point: str | None = None) -> int:
        with self._lock:
            if point is None:
                return len(self.log)
            return sum(1 for rec in self.log if rec[0] == point)


class FutureLedger:
    """Tracks every future a chaos test creates and asserts none strand.

    The resilience layer's core contract: every submitted future resolves
    with a result or a typed exception, under *any* fault.  Tests route
    submissions through :meth:`track` and finish with
    :meth:`assert_all_resolved`.
    """

    def __init__(self):
        self._futures: list = []
        self._lock = threading.Lock()

    def track(self, fut):
        with self._lock:
            self._futures.append(fut)
        return fut

    def __len__(self) -> int:
        with self._lock:
            return len(self._futures)

    def outcomes(self, timeout: float = 10.0) -> dict:
        """Resolve everything and histogram the outcomes by type:
        ``{"ok": n, "Overloaded": n, "DeadlineExceeded": n, ...}``."""
        self.assert_all_resolved(timeout)
        hist: dict = {}
        with self._lock:
            futures = list(self._futures)
        for fut in futures:
            exc = fut.exception(timeout=0)
            key = "ok" if exc is None else type(exc).__name__
            hist[key] = hist.get(key, 0) + 1
        return hist

    def assert_all_resolved(self, timeout: float = 10.0) -> None:
        """Every tracked future must be done within ``timeout`` seconds —
        a stranded future is the exact failure mode this layer exists to
        prevent, so it fails loudly with a count."""
        with self._lock:
            futures = list(self._futures)
        done, stranded = concurrent.futures.wait(futures, timeout=timeout)
        if stranded:
            raise AssertionError(
                f"{len(stranded)} of {len(futures)} futures stranded "
                f"(never resolved within {timeout}s)"
            )
