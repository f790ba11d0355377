"""Percent of its roofline that B1 reaches: the least time of the profiled
requests (bytes and operations of ``work.counts.needed_work`` on their
rows, at the published peaks; bytes bound them) over the device time of
B1's launches (decode, walk, finish)."""

from bench.core.trace import device_seconds
from bench.work.peaks import least_seconds


def read(rec):
    s = device_seconds(rec, rec.get("b1_kernels", ()))
    if not s:
        return None
    return 100.0 * sum(least_seconds(b, o)[0] for b, o in rec["b1_work"]) / s
