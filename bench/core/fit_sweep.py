"""Traffic runner ``fit_sweep``: whole ToaD fits back to back on one
resident binned table, the penalties (ι, ξ) cycling in an order drawn from
the seed, as a training host sweeps them to keep the smallest forest that
holds accuracy.

Set-up draws the rows and labels on the device in chunks (the
configuration's input kind, ``bench/inputs/<kind>.py``), fits the edges with the
program's ``fit_bins`` on the first ``edge_sample_rows`` rows, bins every
chunk with the program's ``apply_bins`` into the trainer's uint8 layout,
and warms up with one whole fit.  The window calls
``ToadModel(...).fit_binned`` and synchronises, fit after fit, until
``--seconds`` have passed; every fit that started in it is counted whole.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bench.core import seeds, spec
from bench.core.trace import profile, sync


def _fit(state, pen):
    from repro_torch.api import ToadModel

    cfg = dataclasses.replace(state["base"], toad_penalty_feature=float(pen[0]),
                              toad_penalty_threshold=float(pen[1]))
    return ToadModel(config=cfg, n_bins=state["n_bins"], device=state["device"]).fit_binned(
        state["bins"], state["y"], state["edges"])


def setup(cell: dict, seed: int, device) -> dict:
    from repro_torch.gbdt.binning import apply_bins, fit_bins
    from repro_torch.gbdt.trainer import GBDTConfig

    t0 = time.perf_counter()
    cfg, tr = cell["config"], cell["traffic"]
    n, d, B = cfg["rows"], cfg["n_features"], cfg["n_bins"]
    chunk = min(cfg["inputs"].get("chunk_rows", n), n)
    sample = min(cfg["inputs"]["edge_sample_rows"], chunk)
    draw = spec.input_kind(cfg).draw
    x, labels = draw(seed, 0, chunk, d, device, labels=True)
    edges_np = fit_bins(x[:sample].cpu().numpy(), B)
    edges = torch.from_numpy(edges_np).to(device)
    bins = torch.empty((n, d), dtype=torch.uint8, device=device)
    y = torch.empty((n,), dtype=torch.float32, device=device)
    for k, lo in enumerate(range(0, n, chunk)):
        if k:
            x, labels = draw(seed, k, min(chunk, n - lo), d, device, labels=True)
        bins[lo:lo + len(x)] = apply_bins(x, edges).to(torch.uint8)
        y[lo:lo + len(x)] = labels
    del x, labels
    pens = [tuple(p) for p in tr["penalties"]]
    order = [pens[i] for i in seeds.permutation(seed, seeds.ORDER, len(pens))]
    state = dict(bins=bins, y=y, edges=edges, edges_np=edges_np, n_bins=B, device=device,
                 base=GBDTConfig(**cfg["gbdt"]), order=order, sample=sample, chunk=chunk)
    sync(device)
    t1 = time.perf_counter()
    _fit(state, order[0])  # every kernel and shape of a whole fit, later rounds too
    sync(device)
    state["phases"] = {"rows, edges and bins": t1 - t0, "warm-up": time.perf_counter() - t1}
    return state


def window(state: dict, seconds: float) -> dict:
    fits = []
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while not fits or time.perf_counter() < t_end:
        pen = state["order"][len(fits) % len(state["order"])]
        t_a = time.perf_counter()
        model = _fit(state, pen)
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


def trace(state: dict, done: dict) -> dict:
    """One more fit, of the first penalties of the order, under the
    profiler; the histogram calls' and the rounds' needed work from the
    rows its trees hold; and the mean wall time of the window's untraced
    fits of the same penalties (the profiler slows the host)."""
    from repro_torch.kernels.histogram import HISTOGRAM_KERNELS

    from bench.work.counts import left_rows_by_level, round_step_work, tree_histogram_calls

    summary, model, wall = profile(lambda: _fit(state, state["order"][0]), state["device"],
                                   host_ops=False)
    n, d = state["bins"].shape
    B = state["n_bins"]
    D = state["base"].max_depth

    def left_rows(leaf_cnt):
        # a round not taken in grew a tree with no split: every row went left
        return [left_rows_by_level(c, D) if float(c.sum()) > 0 else [n] * (D - 1)
                for c in leaf_cnt.cpu()]

    calls = [c for left in left_rows(model.aux["leaf_cnt"])
             for c in tree_histogram_calls(n, d, B, D, left)]
    window_work = [round_step_work(n, d, B, D, left)
                   for f in done["fits"] for left in left_rows(f["leaf_cnt"])]
    same = [f["wall"] for f in done["fits"] if f["pen"] == state["order"][0]]
    return dict(trace=summary, trace_wall_s=wall, untraced_wall_s=sum(same) / len(same),
                rounds=done["rounds"],
                window_fits=[dict(queue=f["queue"], wall=f["wall"]) for f in done["fits"]],
                histogram_kernels=list(HISTOGRAM_KERNELS), b2_calls=calls,
                window_work=window_work)


def reference_bins(state: dict, cell: dict, seed: int):
    """The reference's edges and bins, worked out again from the rows drawn
    anew from the seed, with the numbers of the program's that differ;
    frees the program's bins.  Returns ``(bins, edges, mismatches)``."""
    from bench.reference.binning import bin_rows, fit_bins

    device = state["device"]
    n, d = state["bins"].shape
    chunk = state["chunk"]
    prog_bins = state.pop("bins")
    ref_bins = torch.empty_like(prog_bins)
    mismatch = dict(edges_mismatch=0, bins_mismatch=0)
    draw = spec.input_kind(cell["config"]).draw
    for k, lo in enumerate(range(0, n, chunk)):
        x, _ = draw(seed, k, min(chunk, n - lo), d, device)
        if k == 0:
            edges_np = fit_bins(x[:state["sample"]].cpu().numpy(), cell["config"]["n_bins"])
            mismatch["edges_mismatch"] = int((edges_np != state["edges_np"]).sum())
            edges = torch.from_numpy(edges_np).to(device)
        ref_bins[lo:lo + len(x)] = bin_rows(x, edges)
        mismatch["bins_mismatch"] += int((ref_bins[lo:lo + len(x)]
                                          != prog_bins[lo:lo + len(x)]).sum())
    return ref_bins, edges, mismatch


def judge(fits: list, ref_bins, y, edges, cell: dict) -> dict:
    """The largest of ``reference.trainer.check_fit``'s numbers over
    ``fits`` (tree_faults summed), each judged on every one of its
    trees."""
    from bench.reference.trainer import check_fit

    numbers = dict(split_regret=0.0, leaf_gap=0.0, tree_faults=0)
    gbdt = cell["config"]["gbdt"]
    for f in fits:
        fit = {key: getattr(f["forest"], key).cpu().numpy() for key in
               ("feature", "thr_bin", "is_split", "leaf_ref", "leaf_values",
                "n_leaf_values", "n_trees", "base_score")}
        fit["accepted"] = f["accepted"].cpu().numpy()
        got = check_fit(ref_bins, y, edges, gbdt, f["pen"][0], f["pen"][1], fit,
                        rounds=gbdt["n_rounds"])
        for key, v in got.items():
            numbers[key] = numbers[key] + v if key == "tree_faults" else max(numbers[key], v)
    return numbers


def check(state: dict, done: dict, cell: dict, seed: int) -> dict:
    """The reference's numbers: edges and bins worked out again, and every
    tree of ``check_fits`` fits of the window, drawn from the seed, judged
    node by node (``reference.trainer``)."""
    t0 = time.perf_counter()
    ref_bins, edges, numbers = reference_bins(state, cell, seed)
    done["note"] += f"; reference bins {time.perf_counter() - t0:.2f} s"
    picks = np.random.default_rng(seeds.sub_seed(seed, seeds.KEEP)).permutation(
        len(done["fits"]))[:cell["traffic"]["check_fits"]]
    done["note"] += f"; fits judged {sorted(int(k) for k in picks)}"
    numbers.update(judge([done["fits"][k] for k in sorted(picks)], ref_bins, state["y"],
                         edges, cell))
    return numbers
