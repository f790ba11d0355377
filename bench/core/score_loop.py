"""Traffic runner ``score_loop``: batch scoring in a closed loop with one
client, of rows already on the device.

Each request is a contiguous slice of a resident pool of ``pool_rows``
rows, at an offset drawn from the seed; it calls the model's predictor on
the device rows and reads the (n, C) scores back to the host.  Request
sizes are a fixed set of ``sizes`` log-spaced from ``min_rows`` to
``max_rows``, visited in cycles, each cycle in an order drawn from the
seed: every seed scores the same sizes.

Set-up draws the pool on the device (the configuration's input kind,
``bench/inputs/<kind>.py``), draws the forest (``reference.
forestgen``) at the configuration's widths, compresses it exactly with
``ToadModel.from_forest(...).compress()``, builds the predictor and calls
it once at every size of the set.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench.core import seeds, spec
from bench.core.trace import profile, sync

#: requests drawn ahead of the window (a window takes far fewer)
PLAN = 1 << 17


def request_sizes(tr: dict) -> np.ndarray:
    lo, hi, k = tr["min_rows"], tr["max_rows"], tr["sizes"]
    return np.unique(np.rint(np.exp(np.linspace(np.log(lo), np.log(hi), k))).astype(np.int64))


def make_forest(cfg: dict, seed: int, pool: torch.Tensor) -> dict:
    from bench.reference.binning import fit_bins
    from bench.reference.forestgen import synthetic_forest

    fc = dict(cfg["forest"])
    edges = None
    if fc.pop("edges") == "quantiles":
        edges = fit_bins(pool[:cfg["inputs"]["edge_sample_rows"]].cpu().numpy(), cfg["n_bins"])
    return synthetic_forest(seeds.sub_seed(seed, seeds.FOREST), n_features=cfg["n_features"],
                            n_bins=cfg["n_bins"], edges=edges, **fc)


def setup(cell: dict, seed: int, device) -> dict:
    from repro_torch.api import ToadModel
    from repro_torch.gbdt.forest import forest_from_numpy
    from repro_torch.gbdt.trainer import GBDTConfig

    t0 = time.perf_counter()
    cfg, tr = cell["config"], cell["traffic"]
    pool, _ = spec.input_kind(cfg).draw(seed, 0, tr["pool_rows"], cfg["n_features"], device)
    sync(device)
    t1 = time.perf_counter()
    arrays = make_forest(cfg, seed, pool)
    C = cfg["forest"]["n_ensembles"]
    forest = forest_from_numpy(arrays, n_ensembles=C, device=device)
    gbdt = GBDTConfig(**cfg["gbdt"])
    model = ToadModel.from_forest(forest, config=gbdt, n_bins=cfg["n_bins"],
                                  device=device).compress()
    predict = model.predictor(tr["backend"])
    t2 = time.perf_counter()
    sizes = request_sizes(tr)
    rng = np.random.default_rng(seeds.sub_seed(seed, seeds.ORDER))
    cycles = -(-PLAN // len(sizes))
    plan_n = np.concatenate([sizes[rng.permutation(len(sizes))] for _ in range(cycles)])[:PLAN]
    plan_off = rng.integers(0, tr["pool_rows"] - plan_n + 1)
    for n in sizes:  # every size once: nothing is first seen in the window
        predict(pool[:n]).cpu()
    sync(device)
    phases = {"pool": t1 - t0, "forest and compress": t2 - t1,
              "warm-up": time.perf_counter() - t2}
    return dict(pool=pool, forest=arrays, model=model, predict=predict, plan_n=plan_n,
                plan_off=plan_off, sizes=sizes, C=C, device=device,
                keep=tr["check_requests"], seed=seed, phases=phases)


def window(state: dict, seconds: float) -> dict:
    predict, pool = state["predict"], state["pool"]
    plan_n, plan_off = state["plan_n"], state["plan_off"]
    keep_rng = np.random.default_rng(seeds.sub_seed(state["seed"], seeds.KEEP))
    largest = int(state["sizes"][-1])
    kept: dict[int, torch.Tensor] = {}  # scores of a uniform sample of the requests
    sample: list[int] = []  # its request indices (a reservoir)
    first_largest: dict[int, torch.Tensor] = {}
    lat, host = [], []
    rows = 0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = 0
    while i == 0 or time.perf_counter() < t_end:
        n, off = int(plan_n[i % PLAN]), int(plan_off[i % PLAN])
        t_a = time.perf_counter()
        out = predict(pool[off:off + n])
        t_q = time.perf_counter()
        scores = out.cpu()
        t_b = time.perf_counter()
        lat.append(t_b - t_a)
        host.append(t_q - t_a)
        rows += n
        if len(sample) < state["keep"]:
            sample.append(i)
            kept[i] = scores
        else:
            j = int(keep_rng.integers(0, i + 1))
            if j < state["keep"]:
                kept.pop(sample[j], None)
                sample[j] = i
                kept[i] = scores
        if n == largest and not first_largest:
            first_largest[i] = scores
        i += 1
    window_s = t_b - t_start
    lat_ms = np.asarray(lat) * 1e3
    return dict(attempted=i, failed=0, kept={**kept, **first_largest}, host_s=host, lat_s=lat,
                end_to_end={"score_rows_per_s": rows / window_s,
                            "score_p95_ms": float(np.percentile(lat_ms, 95))})


def trace(state: dict, done: dict) -> dict:
    """One cycle of the plan (every size once) under the profiler, the
    work the packed walk needs for those requests (``work.counts``), and
    the untraced time of such a cycle in the window (the profiler slows
    the host)."""
    from bench.work.counts import needed_work_requests

    predict, pool = state["predict"], state["pool"]
    K = len(state["sizes"])
    reqs = [(int(o), int(n)) for n, o in zip(state["plan_n"][:K], state["plan_off"][:K])]

    def cycle():
        for off, n in reqs:
            predict(pool[off:off + n]).cpu()

    summary, _, wall = profile(cycle, state["device"])
    dev = state["model"].device_packed()
    per_request = [needed_work_requests(dev, pool, [r]) for r in reqs]
    # the untraced time of one cycle: each size's mean latency in the window
    lat = np.asarray(done["lat_s"])
    n_done = state["plan_n"][:len(lat)]
    seen = [lat[n_done == n] for n in state["sizes"]]
    untraced = sum(float(v.mean()) for v in seen) if all(len(v) for v in seen) else None
    return dict(trace=summary, trace_wall_s=wall, untraced_wall_s=untraced, b1_work=per_request,
                b1_kernels=["decode_model_kernel", "packed_predict_kernel",
                            "packed_predict_finish_kernel"],
                host_s=done["host_s"])


def check(state: dict, done: dict, cell: dict, seed: int) -> dict:
    """The sampled requests' scores against the reference's float64 walk of
    the drawn forest (``reference.forest``)."""
    from bench.reference.forest import score

    for key in ("model", "predict"):
        state.pop(key)
    if torch.device(state["device"]).type == "cuda":
        torch.cuda.empty_cache()
    gap = 0.0
    pool = state["pool"]
    for i, scores in done["kept"].items():
        n, off = int(state["plan_n"][i % PLAN]), int(state["plan_off"][i % PLAN])
        want = score(pool[off:off + n], state["forest"], state["C"])
        got = scores.to(want.device, torch.float64)
        gap = max(gap, float((got - want).abs().max()))
    return dict(score_gap=gap, checked_requests=len(done["kept"]))
