"""Device milliseconds a round of the histogram kernels (the program's
``kernels.histogram.HISTOGRAM_KERNELS``), from the profiled fit's trace."""

from bench.core.trace import device_seconds


def read(rec):
    s = device_seconds(rec, rec.get("histogram_kernels", ()))
    return None if s is None else s / rec["rounds"] * 1e3
