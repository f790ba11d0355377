"""Device operations (kernels, copies, fills) a round, counted in the
profiled fit's trace."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["device_ops"]:
        return None
    return t["device_ops"] / rec["rounds"]
