"""Host milliseconds a request that the traced cycle spent in
``packed_predict``'s checks of its arguments: the self time of its
``predict.check`` spans over the cycle's requests (its ``predict`` root
spans; ``repro_torch.tracing``).

Read under the profiler, which slows a cycle: a share of a traced
request's host time. A run on the card only, like the fit's
``train_host_ms`` metrics."""

NAME = "predict.check"


def read(rec):
    t = rec.get("trace")
    if not t or not t["device_ops"]:
        return None
    try:
        from repro_torch import tracing
    except ImportError:  # a program without spans
        return None
    spans = tracing.recorded()
    requests = sum(1 for s in spans if s.name == "predict" and s.parent < 0)
    own = tracing.self_ns_by_name(spans)
    if NAME not in own or not requests:
        return None
    return own[NAME] / requests * 1e-6
