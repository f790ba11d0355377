"""Host milliseconds a round that the traced fit spent in the round's own
work: the self time of the trainer's ``train.round`` and ``train.tree``
spans (the gradients, ``toad_bits``, the accept/merge and the history; a
tree's set-up), summed over the fit and divided by its rounds
(``repro_torch.tracing``).

The spans are read under the profiler, which makes a fit 1.3-1.4x slower:
this is a share of a traced fit's host time. A run on the card only: on
the CPU the plain versions of the kernels run inside the spans."""

NAMES = ("train.round", "train.tree")


def read(rec):
    t = rec.get("trace")
    if not t or not t["device_ops"]:
        return None
    try:
        from repro_torch import tracing
    except ImportError:  # a program without spans
        return None
    own = tracing.self_ns_by_name(tracing.last_trace(tracing.recorded(), "train"))
    if not any(n in own for n in NAMES):
        return None
    return sum(own.get(n, 0) for n in NAMES) / rec["rounds"] * 1e-6
