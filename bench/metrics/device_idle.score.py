"""Percent of a cycle of the plan in which no kernel or copy ran on the
device: the device's busy time in the traced cycle over the untraced time
of such a cycle in the window (the profiler slows the host, so the traced
window itself would read idler)."""

from bench.core.trace import idle_share


def read(rec):
    return idle_share(rec, rec.get("untraced_wall_s"))
