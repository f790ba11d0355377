"""Resilience policy for the serving engines: typed failures, bounded
admission, deadlines, seeded retries, and per-backend circuit breakers.

The paper's deployment story is *unattended* edge serving — a stranded
future or a dead worker thread bricks the node until a human intervenes.
This module is the contract that prevents that: every request submitted to
an engine resolves with either a result or one of the typed errors below,
and overload turns into explicit load shedding instead of latency collapse.

* :class:`ResiliencePolicy` — a JSON-round-trippable dataclass (same idiom
  as :class:`~repro_torch.core.pipeline.CompressionSpec`) carrying the bounded
  queue depth, the request deadline, the retry/backoff schedule (with
  deterministic seeded jitter), the circuit-breaker thresholds, and the
  worker restart budget.
* :class:`CircuitBreaker` — closed → open after N *consecutive* batch
  failures; after a cooldown one half-open probe is granted; a probe
  success closes the breaker, a failure re-opens it for a fresh cooldown.
* The typed error family (:class:`EngineError` and subclasses) — what a
  future resolves with when the engine sheds, expires, stops, or crashes.

A copy of ``repro.api.resilience`` (numpy only), so the port imports
nothing of the JAX package; the policy's JSON is the same in both, so a
policy written by either loads in the other.  The port's
:class:`~repro_torch.api.engine.MicroBatchEngine` consumes all of this;
``docs/resilience.md`` has the failure-mode → observable-outcome table.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np

__all__ = [
    "BadRequest",
    "CircuitBreaker",
    "DeadlineExceeded",
    "EngineError",
    "EngineStopped",
    "Overloaded",
    "ResiliencePolicy",
    "WorkerCrashed",
    "backoff_delays",
]


# --------------------------------------------------------------------------
# Typed errors — what a future resolves with instead of being stranded
# --------------------------------------------------------------------------


class EngineError(RuntimeError):
    """Base class for every typed serving-engine failure."""


class Overloaded(EngineError):
    """Admission rejected: the bounded request queue is full (load shed)."""


class DeadlineExceeded(EngineError, TimeoutError):
    """The request's deadline passed before a prediction was produced."""


class EngineStopped(EngineError):
    """``submit()`` after ``stop()`` (or after the restart budget ran out)."""


class WorkerCrashed(EngineError):
    """The worker thread died with this request in flight."""


class BadRequest(EngineError, ValueError):
    """The submitted row cannot be shaped into the model's feature width."""


# --------------------------------------------------------------------------
# Policy
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Declarative serving-resilience configuration (JSON-serializable).

    Zero values disable the corresponding mechanism, so the default policy
    is behavior-identical to the pre-resilience engine on the happy path.
    """

    #: bounded queue depth; 0 = unbounded (no load shedding)
    max_queue_depth: int = 0
    #: per-request deadline; 0 = none.  Enforced at dequeue (expired
    #: requests complete with DeadlineExceeded without wasting a predict)
    #: and inside ``Future.result()``.
    deadline_ms: float = 0.0
    #: predict retries per backend per batch before counting a failure
    max_retries: int = 0
    #: exponential backoff: base * mult**attempt * (1 + jitter * u), with
    #: u drawn from a generator seeded by ``seed`` (deterministic runs)
    backoff_base_ms: float = 5.0
    backoff_mult: float = 2.0
    backoff_jitter: float = 0.5
    seed: int = 0
    #: consecutive failed batches that open a backend's circuit breaker
    breaker_threshold: int = 3
    #: open -> half-open probe cooldown
    breaker_cooldown_ms: float = 250.0
    #: worker restarts after a crash before the engine gives up
    restart_budget: int = 2
    #: build the degraded-backend fallback chain (cuda -> packed ->
    #: reference) for engines constructed from a model
    fallback: bool = True

    # ----------------------------------------------------------------- json
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "ResiliencePolicy":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown ResiliencePolicy field(s): {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ResiliencePolicy":
        return cls.from_dict(json.loads(s))


def backoff_delays(policy: ResiliencePolicy, n: int | None = None):
    """Yield the policy's backoff delays in seconds, deterministically.

    Same policy (same seed) -> same jittered schedule, so faulted runs are
    reproducible.  ``n`` defaults to ``policy.max_retries``.
    """
    rng = np.random.default_rng(policy.seed)
    n = policy.max_retries if n is None else n
    for attempt in range(n):
        step = policy.backoff_base_ms * policy.backoff_mult**attempt
        yield (step * (1.0 + policy.backoff_jitter * float(rng.random()))) / 1e3


# --------------------------------------------------------------------------
# Circuit breaker
# --------------------------------------------------------------------------


class CircuitBreaker:
    """closed → open after ``threshold`` consecutive failures; after
    ``cooldown_s`` one half-open probe is granted (``allow()`` returns True
    once, then blocks again until the probe reports).  ``record_success``
    closes the breaker; ``record_failure`` re-opens it for a fresh cooldown.

    ``clock`` is injectable for deterministic tests (defaults to
    ``time.monotonic``).
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 0.25, clock=time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._open = False
        self._opened_at = 0.0

    def _state_locked(self) -> str:
        if not self._open:
            return "closed"
        if self._clock() - self._opened_at >= self.cooldown_s:
            return "half_open"
        return "open"

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def allow(self) -> bool:
        """Whether a request may be sent through this backend right now."""
        with self._lock:
            s = self._state_locked()
            if s == "closed":
                return True
            if s == "half_open":
                # claim the single probe: concurrent callers wait for the
                # probe's outcome (or the next cooldown) instead of piling on
                self._opened_at = self._clock()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._open = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._open or self._failures >= self.threshold:
                self._open = True
                self._opened_at = self._clock()

    def trip(self) -> None:
        """Force the breaker open immediately."""
        with self._lock:
            self._failures = max(self._failures, self.threshold)
            self._open = True
            self._opened_at = self._clock()

    def __repr__(self) -> str:
        return f"CircuitBreaker(state={self.state!r}, failures={self._failures})"


# --------------------------------------------------------------------------
# CLI plumbing (launch/serve.py)
# --------------------------------------------------------------------------


def add_resilience_args(ap) -> None:
    """Resilience flags for the serving launchers."""
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline in ms (0 = none)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded engine queue depth; full queue sheds "
                         "requests with a typed Overloaded error (0 = "
                         "unbounded)")
    ap.add_argument("--resilience", default=None, metavar="SPEC.json",
                    help="path to a ResiliencePolicy JSON file, the only "
                         "way to the fallback chain; --deadline-ms/"
                         "--max-queue override its fields")


def resolve_policy(args) -> ResiliencePolicy | None:
    """Build the policy from CLI args; None when no resilience flag given
    (the engines then run the zero-overhead legacy path).

    The fallback chain comes only from a ``--resilience`` spec that asks
    for it: ``--deadline-ms``/``--max-queue`` alone give a policy with
    ``fallback`` off, so a bounded queue or a deadline never puts a plain
    traversal behind the kernel (the JAX package turns the chain on
    there)."""
    spec = getattr(args, "resilience", None)
    deadline = float(getattr(args, "deadline_ms", 0.0) or 0.0)
    max_queue = int(getattr(args, "max_queue", 0) or 0)
    if spec is None and deadline == 0.0 and max_queue == 0:
        return None
    if spec is not None:
        with open(spec, "r", encoding="utf-8") as f:
            policy = ResiliencePolicy.from_json(f.read())
    else:
        policy = ResiliencePolicy(fallback=False)
    if deadline:
        policy = dataclasses.replace(policy, deadline_ms=deadline)
    if max_queue:
        policy = dataclasses.replace(policy, max_queue_depth=max_queue)
    return policy
