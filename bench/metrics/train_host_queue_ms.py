"""Host milliseconds a round spent queueing the window's fits: the host
clock from the ``fit_binned`` call until it returns, before the
synchronise, over every round of the window's fits."""


def read(rec):
    fits = rec.get("window_fits")
    if not fits:
        return None
    return sum(f["queue"] for f in fits) / (len(fits) * rec["rounds"]) * 1e3
