"""Spans inside the port: where the host's time goes, step by step.

    with tracing.span("train.hist", rows=n, nodes=k):
        ...

A span records its name, its start and end in nanoseconds, the index of
its parent span (the innermost span open on the same thread when it
opened; -1 for a root), the id of its trace (a root's own, shared by every
span under it: one ``train`` call, one predictor request, one served
batch) and its counts (integers known on the host).  A span's self time is
its duration less what its child spans cover (:func:`self_ns`).

**Off is the default.**  Off, :func:`span` returns one shared object that
does nothing: a flag test, and nothing allocated.  Spans record while

* a ``torch.profiler`` profile is active (whatever its activities), so a
  profiled stretch records the program's spans with no change to its
  runner; each span then also opens a ``record_function`` range of its
  name, which a profile that records host events keeps;
* inside :func:`collect`, which returns the spans recorded inside it.

Neither reads a tensor back nor synchronises: a span costs the host two
clock reads and a record, and the device nothing.

**The clock** is the profiler's: Unix-epoch nanoseconds (``time.time_ns``),
the base that the profiler's host events and its device timestamps are
given in (``kineto_results.events()``'s ``start_ns``), so a span and the
device operations it queued lie on one time line.

Spans are kept in memory in a bounded store (:data:`CAPACITY`) that counts
what it drops (:func:`dropped`); :func:`recorded` returns them and
:func:`clear` empties the store.  Kernel launches are not counted here: the
kernels' ``.launches`` attributes count them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = [
    "CAPACITY",
    "Span",
    "clear",
    "clock_ns",
    "collect",
    "dropped",
    "last_trace",
    "recorded",
    "self_ns",
    "self_ns_by_name",
    "span",
]

#: the store's size: a depth-8 fit records ~35 spans a tree
CAPACITY = 1 << 18

#: the spans' clock: Unix-epoch nanoseconds, the profiler's base
clock_ns = time.time_ns


@dataclasses.dataclass
class Span:
    """One recorded span.  ``index`` is its place in :func:`recorded`,
    ``parent`` its parent's ``index`` (-1 for a root); ``end_ns`` is 0
    while it is open."""

    name: str
    start_ns: int
    end_ns: int
    index: int
    parent: int
    trace: int
    counts: dict

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


_lock = threading.Lock()
_store: list[Span] = []
_dropped = 0
_collecting = 0
_traces = itertools.count()
_local = threading.local()


class _Off:
    """The span handed out while nothing records: does nothing."""

    __slots__ = ()

    def since(self, start_ns: int) -> "_Off":
        return self

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Open:
    """A span being recorded: its record is stored when it opens."""

    __slots__ = ("name", "counts", "start_ns", "record", "range")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts
        self.start_ns = 0
        self.record = None
        self.range = None

    def since(self, start_ns: int) -> "_Open":
        """Start the span at ``start_ns`` (a :data:`clock_ns` reading taken
        before it opened): for work timed before it was known to be a
        span's, such as a wait that may end with nothing to do."""
        self.start_ns = start_ns
        return self

    def __enter__(self) -> Span | None:
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        with _lock:
            if len(_store) >= CAPACITY:
                _dropped += 1
                stack.append(None)
                return None
            if top is not None:
                parent, trace = top.record.index, top.record.trace
            else:
                parent, trace = -1, next(_traces)
            self.record = Span(self.name, 0, 0, len(_store), parent, trace, self.counts)
            _store.append(self.record)
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            # record_function's C++ form: the Python form's own host time
            # would lie between the span's clock reads and its range's
            self.range = _RecordFunctionFast(self.name)
            self.range.__enter__()
        self.record.start_ns = self.start_ns or clock_ns()
        return self.record

    def __exit__(self, *exc) -> None:
        _local.stack.pop()
        if self.record is None:
            return None
        self.record.end_ns = clock_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        return None


def span(name: str, **counts):
    """A context manager that records the span ``name`` with ``counts``
    while spans record (see the module's doc), and does nothing
    otherwise; ``span(...).since(t)`` starts it at the clock reading ``t``."""
    if not (_collecting or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, counts)


@contextlib.contextmanager
def collect():
    """Record spans inside the block, on every thread; yields the list of
    the spans that opened inside it, filled when the block ends (a span
    another thread still holds open has ``end_ns`` 0 until it closes)."""
    global _collecting
    got: list[Span] = []
    with _lock:
        _collecting += 1
        first = len(_store)
    try:
        yield got
    finally:
        with _lock:
            _collecting -= 1
            got.extend(_store[first:])


def recorded() -> list[Span]:
    """Every span in the store, in the order they opened."""
    with _lock:
        return list(_store)


def dropped() -> int:
    """Spans the full store turned away since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    """Empty the store and its count of dropped spans (with no span open)."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0


def self_ns(spans: list[Span]) -> list[int]:
    """Each span's self time: its duration less the durations of its
    children in ``spans``."""
    at = {s.index: k for k, s in enumerate(spans)}
    out = [s.duration_ns for s in spans]
    for s in spans:
        k = at.get(s.parent)
        if k is not None:
            out[k] -= s.duration_ns
    return out


def self_ns_by_name(spans: list[Span]) -> dict[str, int]:
    """The summed self time of ``spans`` by name."""
    out: dict[str, int] = {}
    for s, t in zip(spans, self_ns(spans)):
        out[s.name] = out.get(s.name, 0) + t
    return out


def last_trace(spans: list[Span], root: str) -> list[Span]:
    """The spans of the trace of the last root span named ``root``, or
    none."""
    ids = [s.trace for s in spans if s.name == root and s.parent < 0]
    return [s for s in spans if s.trace == ids[-1]] if ids else []
