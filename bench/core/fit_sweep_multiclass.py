"""Traffic runner ``fit_sweep_multiclass``: ``fit_sweep``'s whole fits back
to back on one resident binned table, (ι, ξ) cycling in an order drawn from
the seed, for a multiclass configuration (C trees a round, round-major).

Set-up is ``fit_sweep``'s, but its warm-up fit runs the traffic's
``warmup_rounds`` rounds: enough for the leaf table to fill, so that its
full-table path has run too.  The window runs fits until ``--seconds`` have
passed and at least ``min_fits`` fits are done (a fit takes most of a
20 s window), each counted whole; ``train_round_ms`` is the wall time of a
round of C trees.  The traced fit is ``fit_sweep``'s.  The check judges
every tree of ``check_fits`` fits of the window, drawn from the seed, with
the multiclass judge ``reference.trainer_multiclass``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from bench.core import fit_sweep, seeds
from bench.core.fit_sweep import reference_bins, trace
from bench.core.trace import sync

__all__ = ["setup", "window", "trace", "judge", "check"]


def setup(cell: dict, seed: int, device) -> dict:
    gbdt = cell["config"]["gbdt"]
    warm = dict(gbdt, n_rounds=min(cell["traffic"]["warmup_rounds"], gbdt["n_rounds"]))
    state = fit_sweep.setup(dict(cell, config=dict(cell["config"], gbdt=warm)), seed, device)
    state["base"] = dataclasses.replace(state["base"], n_rounds=gbdt["n_rounds"])
    state["min_fits"] = cell["traffic"]["min_fits"]
    return state


def window(state: dict, seconds: float) -> dict:
    fits = []
    t_end = time.perf_counter() + seconds
    while len(fits) < state["min_fits"] or time.perf_counter() < t_end:
        pen = state["order"][len(fits) % len(state["order"])]
        t_a = time.perf_counter()
        model = fit_sweep._fit(state, pen)
        t_q = time.perf_counter()
        sync(state["device"])
        t_b = time.perf_counter()
        fits.append(dict(pen=pen, wall=t_b - t_a, queue=t_q - t_a, forest=model.forest,
                         accepted=model.history["accepted"], leaf_cnt=model.aux["leaf_cnt"]))
        del model
    rounds = state["base"].n_rounds
    note = "fits (ms a round): " + " ".join(f"{f['wall'] / rounds * 1e3:.1f}" for f in fits)
    return dict(fits=fits, rounds=rounds, attempted=len(fits), failed=0, note=note,
                end_to_end={"train_round_ms": sum(f["wall"] for f in fits)
                            / (len(fits) * rounds) * 1e3})


#: numbers of the judge that add up over fits (the compared ones take the largest)
_COUNTS = ("tree_faults", "faults_dead", "faults_invalid", "faults_ref", "faults_empty_round",
           "weight_ties", "empty_class_trees")


def judge(fits: list, ref_bins, y, edges, cell: dict) -> dict:
    """``reference.trainer_multiclass.check_fit``'s numbers over ``fits``:
    the counts summed, the rest the largest; ``table_full_round`` and
    ``worst`` those of the fit with the largest ``split_regret``."""
    from bench.reference.trainer_multiclass import check_fit

    numbers = dict(split_regret=0.0, leaf_gap=0.0, table_regret=0.0,
                   **{k: 0 for k in _COUNTS}, table_full_round=-1, worst=None)
    gbdt = cell["config"]["gbdt"]
    for f in fits:
        fit = {key: getattr(f["forest"], key).cpu().numpy() for key in
               ("feature", "thr_bin", "is_split", "leaf_ref", "leaf_values",
                "n_leaf_values", "n_trees", "base_score")}
        fit["accepted"] = f["accepted"].cpu().numpy()
        got = check_fit(ref_bins, y, edges, gbdt, f["pen"][0], f["pen"][1], fit,
                        n_classes=gbdt["n_classes"], rounds=gbdt["n_rounds"])
        if got["split_regret"] >= numbers["split_regret"]:
            numbers.update(table_full_round=got["table_full_round"], worst=got["worst"])
        for key in ("split_regret", "leaf_gap", "table_regret"):
            numbers[key] = max(numbers[key], got[key])
        for key in _COUNTS:
            numbers[key] += got[key]
    return numbers


def check(state: dict, done: dict, cell: dict, seed: int) -> dict:
    """The reference's numbers: edges and bins worked out again, and every
    tree of ``check_fits`` fits of the window, drawn from the seed, judged
    node by node (``reference.trainer_multiclass``)."""
    t0 = time.perf_counter()
    ref_bins, edges, numbers = reference_bins(state, cell, seed)
    done["note"] += f"; reference bins {time.perf_counter() - t0:.2f} s"
    picks = np.random.default_rng(seeds.sub_seed(seed, seeds.KEEP)).permutation(
        len(done["fits"]))[:cell["traffic"]["check_fits"]]
    done["note"] += (f"; fits judged {sorted(int(k) for k in picks)}, (iota, xi) "
                     + " ".join(str(done["fits"][k]["pen"]) for k in sorted(picks)))
    numbers.update(judge([done["fits"][k] for k in sorted(picks)], ref_bins, state["y"],
                         edges, cell))
    return numbers
