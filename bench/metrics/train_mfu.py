"""Percent of the card's peak that the whole training step reaches: the
least time of every round's counted work in the window's fits
(``work.counts.round_step_work`` on the rows each tree's nodes held: the
histograms, the split search, the routing and the gradients, at the
published peaks; bytes bound them) over those fits' wall time, untraced."""

from bench.work.peaks import least_seconds


def read(rec):
    fits = rec.get("window_fits")
    if not fits or not rec.get("window_work") or not rec["trace"]["device_ops"]:
        return None  # a share of the card's peak exists only for a run on the card
    work = sum(least_seconds(b, o)[0] for b, o in rec["window_work"])
    return 100.0 * work / sum(f["wall"] for f in fits)
