"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a short
stretch of the cell's own work, reduced to what the metric readers take.

Nothing is written to disk: the profile is read in memory."""

from __future__ import annotations

import time

import numpy as np


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile(work, device, host_ops: bool = True):
    """Run ``work()`` under ``torch.profiler`` and synchronise; returns
    ``(summary, result of work, host seconds)``.  ``host_ops``: record the
    host's operators too (each costs the host a few microseconds, which
    shows in a host-paced window); without them the host is seen through
    its CUDA runtime calls alone."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    on_card = torch.device(device).type == "cuda"
    activities = (([ProfilerActivity.CPU] if host_ops or not on_card else [])
                  + ([ProfilerActivity.CUDA] if on_card else []))
    sync(device)
    with _profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = work()
        sync(device)
        wall = time.perf_counter() - t0
    return summarize(prof.profiler.kineto_results.events()), out, wall


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Sorted, disjoint unions of the (k, 2) [start, end) intervals."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.r_[np.nonzero(new)[0][1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], 1)


def innermost_running(intervals: np.ndarray, times: np.ndarray) -> np.ndarray:
    """For each of ``times``, the index of the interval of ``intervals``
    ((k, 2) [start, end)) that runs then and started last, or -1.

    One sweep in order of start keeps the intervals still running at each
    start as a stack; the intervals that run at a time ``t`` are then the
    stack at the last start before ``t``, less those ended by ``t``."""
    order = np.argsort(intervals[:, 0], kind="stable")
    starts, ends = intervals[order, 0], intervals[order, 1]
    below = np.full(len(order), -1)
    stack: list[int] = []
    for k in range(len(order)):
        while stack and ends[stack[-1]] <= starts[k]:
            stack.pop()
        below[k] = stack[-1] if stack else -1
        stack.append(k)
    out = np.full(len(times), -1)
    for i, k in enumerate(np.searchsorted(starts, times, side="right") - 1):
        while k >= 0 and ends[k] <= times[i]:
            k = below[k]
        out[i] = order[k] if k >= 0 else -1
    return out


def summarize(events, top: int = 10) -> dict:
    """Device time by kernel name, the device's busy time and the traced
    window (both from the trace), and the idle gaps by what the host was
    doing when each began (the innermost host event running then: an
    operator, or a CUDA runtime call).  ``events``: the profiler's raw
    events (``kineto_results.events()``), times in nanoseconds."""
    from torch.autograd import DeviceType

    dev_name, dev_iv, cpu_name, cpu_iv = [], [], [], []
    for e in events:
        a = e.start_ns()
        iv = (a * 1e-3, (a + e.duration_ns()) * 1e-3)  # microseconds
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            dev_name.append(e.name())
            dev_iv.append(iv)
        elif kind == DeviceType.CPU:
            cpu_name.append(e.name())
            cpu_iv.append(iv)
    dev_iv = np.asarray(dev_iv, np.float64).reshape(-1, 2)
    cpu_iv = np.asarray(cpu_iv, np.float64).reshape(-1, 2)
    kernel_s: dict[str, float] = {}
    kernel_n: dict[str, int] = {}
    for name, (a, b) in zip(dev_name, dev_iv):
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
        kernel_n[name] = kernel_n.get(name, 0) + 1
    busy = _merge(dev_iv)
    everything = np.concatenate([dev_iv, cpu_iv]) if len(cpu_iv) else dev_iv
    lo, hi = (everything[:, 0].min(), everything[:, 1].max()) if len(everything) else (0, 0)
    bounds = np.r_[lo, busy.reshape(-1), hi].reshape(-1, 2)  # (gap start, gap end)
    gaps = bounds[bounds[:, 1] > bounds[:, 0]]
    idle: dict[str, float] = {}
    running = innermost_running(cpu_iv, gaps[:, 0])
    for (a, b), k in zip(gaps, running):
        label = cpu_name[k] if k >= 0 else "host outside any recorded call"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return dict(
        kernel_s=kernel_s,
        kernel_n=kernel_n,
        device_ops=int(len(dev_iv)),
        busy_s=float((busy[:, 1] - busy[:, 0]).sum() * 1e-6) if len(busy) else 0.0,
        window_s=float((hi - lo) * 1e-6),
        breakdown=dict(device_ops=rank(kernel_s), idle_gaps=rank(idle)),
    )


def device_seconds(rec: dict, names) -> float | None:
    """Device seconds of the kernels whose names contain one of ``names``;
    None where the trace holds none of them."""
    t = rec.get("trace")
    if not t:
        return None
    hit = [s for k, s in t["kernel_s"].items() if any(n in k for n in names)]
    return sum(hit) if hit else None


def idle_share(rec: dict, wall_s: float | None) -> float | None:
    """Percent of ``wall_s`` seconds of the traced work in which no
    operation ran on the device (the trace's busy time); None without a
    device trace or a wall time."""
    t = rec.get("trace")
    if not t or t["busy_s"] <= 0 or not wall_s:
        return None
    return 100.0 * (1.0 - t["busy_s"] / wall_s)
