"""Percent of its roofline that B2 reaches: the least time of every
histogram call of the profiled fit (bytes and adds of
``work.counts.histogram_work`` at the published peaks, the larger of the
two; bytes bound them), over the histogram kernels' device time."""

from bench.core.trace import device_seconds
from bench.work.peaks import least_seconds


def read(rec):
    s = device_seconds(rec, rec.get("histogram_kernels", ()))
    if not s:
        return None
    return 100.0 * sum(least_seconds(b, o)[0] for b, o in rec["b2_calls"]) / s
