"""Host milliseconds a request spent in the predictor: the host clock
from the call until it returns, before the read-back, over the window's
requests."""


def read(rec):
    host = rec.get("host_s")
    if not host:
        return None
    return sum(host) / len(host) * 1e3
