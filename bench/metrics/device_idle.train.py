"""Percent of a fit in which no kernel or copy ran on the device: the
device's busy time in the profiled fit over the mean wall time of the
window's untraced fits of the same penalties (the profiler slows the
host, so the traced window itself would read idler)."""

from bench.core.trace import idle_share


def read(rec):
    return idle_share(rec, rec.get("untraced_wall_s"))
