"""Percent of the card's peak that whole requests reach: the least time of
one cycle of the plan's counted work (``work.counts.needed_work``, at the
published peaks) over the untraced time of such a cycle in the window
(each size's mean latency, read-back included; host clock)."""

from bench.work.peaks import least_seconds


def read(rec):
    if not rec.get("trace") or not rec["trace"]["device_ops"] or not rec.get("untraced_wall_s"):
        return None  # a share of the card's peak exists only for a run on the card
    return 100.0 * sum(least_seconds(b, o)[0] for b, o in rec["b1_work"]) / rec["untraced_wall_s"]
