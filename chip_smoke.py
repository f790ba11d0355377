#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` each, all started together), holds each against its plain PyTorch
version on the card, then drives the port's main paths through its own
entry points: serving a full-width model (``packed_predict``), training one
at the full width of ``toad_gbdt`` on 2^22 rows (``histogram``) and serving
it, trees trained on the card against trees trained on the CPU, the serve
CLI training in-process, and label-exact early-exit serving of a 64-round
full-width model (``packed_predict_early_exit``), through its entry point
and through the serve CLI.  Times each kernel beside its bound, its plain
version and, where one exists, a PyTorch call computing the same function,
and ends with one JSON line.  It needs a card: without CUDA it fails at
once.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def synthetic_forest(
    seed: int = 0,
    *,
    n_trees: int = 256,
    max_depth: int = 8,
    n_features: int = 256,
    n_bins: int = 256,
    n_ensembles: int = 1,
    n_used_features: int = 48,
    max_thr_per_feature: int = 16,
    n_leaf_values: int = 4096,
) -> dict:
    """Forest arrays (the artifact's forest fields) drawn from ``seed``.

    The defaults are the widths of the repo's GBDT configuration
    (``src/repro/configs/toad_gbdt.py``): 256 features, 256 bins, depth 8,
    binary.  Reuse is shaped as a ToaD-trained forest shows it: splits use
    ``n_used_features`` features with at most ``max_thr_per_feature``
    thresholds each, and leaves reference a shared table of
    ``n_leaf_values`` values.  The root splits (when any feature is used);
    every other node splits with probability 0.85 if its parent split, so
    unsplit subtrees stay unsplit.
    """
    rng = np.random.default_rng(seed)
    E = n_bins - 1
    I = 2**max_depth - 1
    L = 2**max_depth
    edges = np.sort(rng.standard_normal((n_features, E)), axis=1).astype(np.float32)
    used = rng.choice(n_features, size=n_used_features, replace=False)
    pools = [
        np.sort(rng.choice(E, size=min(max_thr_per_feature, E), replace=False))
        for _ in used
    ]
    is_split = np.zeros((n_trees, I), bool)
    feature = np.zeros((n_trees, I), np.int32)
    thr_bin = np.zeros((n_trees, I), np.int32)
    if n_used_features:
        is_split[:, 0] = True
        for i in range(1, I):
            is_split[:, i] = is_split[:, (i - 1) // 2] & (rng.random(n_trees) < 0.85)
        which = rng.integers(0, n_used_features, size=(n_trees, I))
        feature[:] = used[which]
        pick = rng.integers(0, max_thr_per_feature, size=(n_trees, I))
        for k, pool in enumerate(pools):
            mask = which == k
            thr_bin[mask] = pool[pick[mask] % len(pool)]
        feature[~is_split] = 0
        thr_bin[~is_split] = 0
    return {
        "feature": feature,
        "thr_bin": thr_bin,
        "is_split": is_split,
        "leaf_ref": rng.integers(0, n_leaf_values, size=(n_trees, L)).astype(np.int32),
        "leaf_values": (0.1 * rng.standard_normal(n_leaf_values)).astype(np.float32),
        "n_leaf_values": np.asarray(n_leaf_values, np.int32),
        "n_trees": np.asarray(n_trees, np.int32),
        "edges": edges,
        "base_score": (0.1 * rng.standard_normal(n_ensembles)).astype(np.float32),
    }


def early_exit_forest(seed: int = 0, *, rate: float = 0.75, **kw) -> dict:
    """``synthetic_forest``'s arrays with a boosted ensemble's decay: tree
    ``t``'s leaves scaled by ``rate ** t``, each tree over its own slice of
    the leaf table (T · 2^D values), so the first trees carry most of the
    score and rows become decision-final at different tree blocks."""
    arrays = synthetic_forest(seed, **kw)
    T, L = arrays["leaf_ref"].shape
    scale = (rate ** np.arange(T, dtype=np.float64)).astype(np.float32)[:, None]
    arrays["leaf_values"] = (arrays["leaf_values"][arrays["leaf_ref"]] * scale).reshape(-1)
    arrays["leaf_ref"] = np.arange(T * L, dtype=np.int32).reshape(T, L)
    arrays["n_leaf_values"] = np.asarray(T * L, np.int32)
    return arrays


# published peaks of one H100 SXM (the card's data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_FULL = 262_144  # rows of the full-width kernel case and of the timing


def needed_work(p, x, trees=None):
    """What packed inference of the rows ``x`` needs of the card, counted
    along each row's real paths through the model ``p`` (a ``DevicePacked``
    with at least one used feature): through every tree, or, given
    ``trees`` (n,), through the first ``trees[r]`` trees of row ``r`` (the
    trees an early-exit row evaluates).

    Returns ``(n_bytes, n_ops, scores)``.  Bytes: each (row, feature) pair
    that a split on the row's paths compares, read once; each node word and
    leaf reference a path visits, read once; the small tables whole; the
    scores written once.  Operations: one fp32 compare per split node
    visited and one add per tree and row.  ``scores`` are the sums of the
    leaves reached, for checking that the counted paths are the real ones.
    """
    import torch

    n = x.shape[0]
    T, I = p.words.shape
    n_fu = p.used_features.numel()
    C = p.n_ensembles
    words = p.words.long() & 0xFFFFFFFF
    tmask = (1 << p.tidx_bits) - 1
    uf = torch.cat([p.used_features.long(), p.used_features.new_zeros(1).long()])
    off, thr = p.thr_offsets.long(), p.thr_table
    roots = torch.arange(T, device=x.device) * I
    live = (torch.ones((n, T), dtype=torch.bool, device=x.device) if trees is None
            else torch.arange(T, device=x.device)[None, :] < trees.long()[:, None])
    idx = torch.zeros((n, T), dtype=torch.long, device=x.device)
    node_seen = torch.zeros(T * I, dtype=torch.bool, device=x.device)
    pair_seen = torch.zeros((n, n_fu + 1), dtype=torch.bool, device=x.device)
    compares = 0
    for _ in range(p.max_depth):
        node = roots + idx
        node_seen[node[live]] = True
        w = words.view(-1)[node]
        ref = (w >> p.tidx_bits).clamp(max=n_fu)  # n_fu: unsplit, reads no x
        split = ref < n_fu
        compares += int((split & live).sum())
        pair_seen.scatter_(1, torch.where(live, ref, n_fu), True)
        k = (off[ref] + (w & tmask)).clamp(0, thr.numel() - 1)
        right = split & ~(torch.gather(x, 1, uf[ref]) <= thr[k])
        idx = 2 * idx + 1 + right.long()
    leaf = torch.arange(T, device=x.device) * (I + 1) + idx - I
    leaf_seen = torch.zeros(T * (I + 1), dtype=torch.bool, device=x.device)
    leaf_seen[leaf[live]] = True
    values = torch.where(live, p.leaf_values[p.leaf_ref.view(-1)[leaf].long()], 0.0)
    scores = p.base_score[None, :].expand(n, C).clone()
    scores.index_add_(1, torch.arange(T, device=x.device) % C, values)
    tables = sum(a.numel() for a in (p.leaf_values, p.thr_table, p.thr_offsets,
                                     p.used_features, p.base_score))
    n_bytes = 4 * (int(pair_seen[:, :n_fu].sum()) + int(node_seen.sum())
                   + int(leaf_seen.sum()) + tables + n * C)
    return n_bytes, compares + int(live.sum()), scores


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---- training (kernel B2) -----------------------------------------------------

N_TRAIN = 1 << 22  # rows of the full-width fit: the config's 2^24 is a whole mesh's
N_HIST_CASE = 1 << 18  # rows of the full-width histogram cases


def draw_rows(seed: int, n: int, d: int, workers: int = 8):
    """(n, d) float32 standard-normal rows and the labels of a nonlinear rule
    of three features, drawn from ``seed`` with numpy (blocks of rows on a
    few threads, one spawned stream each)."""
    import concurrent.futures

    seqs = np.random.SeedSequence(seed).spawn(workers)
    X = np.empty((n, d), np.float32)
    step = -(-n // workers)

    def fill(k):
        np.random.default_rng(seqs[k]).standard_normal(
            (min(step, n - k * step), d), dtype=np.float32, out=X[k * step:(k + 1) * step])

    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        list(pool.map(fill, range(workers)))
    y = (X[:, 0] - X[:, 1] + 0.3 * X[:, 2] ** 2 > 0).astype(np.float32)
    return X, y


def histogram_work(bins, gh, pos, n_nodes: int, n_bins: int):
    """What one histogram call needs of the card: each input read once (bins
    at their storage width, gh, pos), the output written once; one fp32 add
    per (kept row, feature, channel).  Returns ``(n_bytes, n_ops)``."""
    import torch

    n, d = bins.shape
    CH = gh.shape[1]
    kept = int(((pos >= 0) & (pos < n_nodes)).sum())
    n_bytes = (n * d * bins.element_size() + gh.numel() * 4 + pos.numel() * 4
               + n_nodes * d * n_bins * CH * 4)
    return n_bytes, kept * d * CH


def check_histogram_kernel(dev) -> float:
    """The histogram kernel against its plain version on the card: within
    1e-5 (atol and rtol), counts equal, two runs equal to the bit.

    The plain version runs on the same channels in float64: in float32 on
    the card it sums with float atomics, and with ~1,000 rows a cell at
    n = 2^18 its own error exceeds 1e-5 (printed beside each case), while
    the kernel's int64 fixed-point sums are exact to ~2^-39 a row.  Returns
    the largest |kernel - plain (float64)|."""
    import torch

    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.ops import build_histogram, sibling_subtraction_histograms
    from repro_torch.kernels.ref import histogram_ref

    gen = torch.Generator(device=dev).manual_seed(11)

    def inputs(n, d, n_bins, n_nodes, CH=3, dtype=torch.uint8, oob=False):
        bins = torch.randint(0, n_bins, (d, n), device=dev, generator=gen).to(dtype).t()
        gh = torch.stack([torch.randn(n, device=dev, generator=gen),
                          torch.rand(n, device=dev, generator=gen) + 0.05,
                          torch.ones(n, device=dev)], -1)[:, :CH].contiguous()
        # the last node stays empty
        pos = torch.randint(0, max(n_nodes - 1, 1), (n,), device=dev, generator=gen)
        if oob:
            drop = torch.rand(n, device=dev, generator=gen)
            pos = torch.where(drop < 0.05, n_nodes, torch.where(drop > 0.95, -1, pos))
        return bins, gh, pos.to(torch.int32)

    N = N_HIST_CASE
    cases = [(f"full width d=256, 256 bins, n={N}, {k} node(s)", inputs(N, 256, 256, k), k, 256)
             for k in (1, 9, 64)]
    cases += [(f"n={n}, d=256, 9 nodes", inputs(n, 256, 256, 9), 9, 256) for n in (1, 511, 513)]
    cases += [
        ("CH=2, 64 nodes", inputs(N, 64, 256, 64, CH=2), 64, 256),
        ("int32 bins, 64 bins, 8 nodes, out-of-range pos",
         inputs(N, 32, 64, 8, dtype=torch.int32, oob=True), 8, 64),
        ("uint8 bins, row-major, out-of-range pos",
         tuple(t.contiguous() for t in inputs(N, 48, 256, 16, oob=True)), 16, 256),
    ]
    max_err = 0.0
    for label, (bins, gh, pos), n_nodes, n_bins in cases:
        got = histogram(bins, gh, pos, n_nodes=n_nodes, n_bins=n_bins)
        again = histogram(bins, gh, pos, n_nodes=n_nodes, n_bins=n_bins)
        want = histogram_ref(bins, gh.double(), pos, n_nodes, n_bins)
        fp32 = histogram_ref(bins, gh, pos, n_nodes, n_bins)
        torch.cuda.synchronize()
        max_err = max(max_err, _compare(label, got, want, again, fp32,
                                        counts=gh.shape[1] == 3))
    bins, gh, pos = inputs(N, 256, 256, 64)
    gh16 = gh.to(torch.bfloat16)
    got = build_histogram(bins, gh16, pos, n_nodes=64, n_bins=256, method="cuda")
    want = histogram_ref(bins, gh16.double(), pos, 64, 256)
    max_err = max(max_err, _compare("bf16 channels, 64 nodes", got, want, got,
                                    histogram_ref(bins, gh16, pos, 64, 256)))
    child = pos.clamp(0, 63)
    parent = torch.div(child, 2, rounding_mode="floor")
    parent_hist = histogram(bins, gh, parent, n_nodes=32, n_bins=256)
    sub = sibling_subtraction_histograms(bins, gh, child, parent_hist, n_bins=256, method="cuda")
    direct = histogram_ref(bins, gh.double(), child, 64, 256)
    max_err = max(max_err, _compare("sibling subtraction vs a direct build, 64 children",
                                    sub, direct, sub, histogram_ref(bins, gh, child, 64, 256)))
    return max_err


def _compare(label, got, want, again, fp32, counts=True) -> float:
    """``got`` against the float64 plain version ``want``; ``fp32`` is the
    plain version in float32, whose own distance is printed beside."""
    import torch

    if not torch.isfinite(got).all() or got.shape != want.shape:
        raise SystemExit(f"[hist] {label}: bad output {tuple(got.shape)}")
    err = float((got.double() - want).abs().max()) if got.numel() else 0.0
    own = float((fp32.double() - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5):
        raise SystemExit(f"[hist] {label}: max|Δ| {err:.3e} exceeds 1e-5")
    if counts and not torch.equal(got[..., 2].double(), want[..., 2]):
        raise SystemExit(f"[hist] {label}: counts differ from the plain version")
    if not torch.equal(got, again):
        raise SystemExit(f"[hist] {label}: two runs differ")
    print(f"[hist] {label}: max|Δ| {err:.3e} vs the plain version in float64 "
          f"(the float32 plain version: {own:.3e}), counts equal, two runs equal "
          "to the bit")
    return err


def train_full_width(dev, smi: str) -> dict:
    """The main path of training: ``ToadModel.fit`` at the full width of
    ``toad_gbdt`` on 2^22 rows, then compress and predict on the card."""
    import time

    import torch

    from repro_torch.api import ToadModel
    from repro_torch.configs import get_gbdt_config
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.predict import packed_predict

    wl = get_gbdt_config("toad_gbdt")
    t0 = time.perf_counter()
    X, y = draw_rows(3, N_TRAIN, wl.n_features)
    print(f"[train] drew {N_TRAIN} x {wl.n_features} rows in "
          f"{time.perf_counter() - t0:.2f} s")
    model = ToadModel(config=wl.gbdt, n_bins=wl.n_bins, device=dev)
    histogram.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(X, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = histogram.launches
    cfg = wl.gbdt
    grown = cfg.n_rounds * cfg.n_ensembles
    n_trees = int(model.forest.n_trees)
    n_splits = int(model.forest.is_split[:n_trees].sum())
    accepted = model.history["accepted"].tolist()
    toad_bytes = float(model.aux["toad_bytes"])
    if launches < (cfg.max_depth + 1) * grown:
        raise SystemExit(f"[train] the histogram kernel ran {launches} times for "
                         f"{grown} trees of depth {cfg.max_depth}")
    if n_trees < 1 or n_splits < 1:
        raise SystemExit(f"[train] trained {n_trees} trees with {n_splits} splits")
    acc = model.score(X, y)
    print(f"[train] fit {N_TRAIN} x {wl.n_features}, {wl.n_bins} bins, depth "
          f"{cfg.max_depth}, {cfg.n_rounds} rounds (binning included): {fit_s:.3f} s; "
          f"histogram launches {launches}; trees {n_trees}, splits {n_splits}, "
          f"rounds accepted {accepted}; toad_bytes {toad_bytes}; train accuracy {acc:.4f}")
    if not acc > 0.75:
        raise SystemExit(f"[train] train accuracy {acc:.4f} is no better than chance")

    # the rounds alone, on the same bins: binning out of the window
    from repro_torch.gbdt import apply_bins, train

    edges = model.forest.edges
    bins = apply_bins(torch.from_numpy(X).to(dev), edges)
    yt = torch.from_numpy(y).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forest, _, _ = train(cfg, bins, yt, edges)
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0
    for k in ("feature", "thr_bin", "is_split", "leaf_ref", "leaf_values", "n_trees"):
        if not torch.equal(getattr(forest, k), getattr(model.forest, k)):
            raise SystemExit(f"[train] a second run on the same data differs in {k}")
    print(f"[train] {cfg.n_rounds} rounds on the same bins: {rounds_s:.3f} s, "
          f"{rounds_s / cfg.n_rounds * 1e3:.1f} ms per round; the host had queued "
          f"them after {queued:.3f} s; the trees equal the first run's to the bit")
    breakdown = profile_round(cfg, bins, yt, edges)
    del bins

    model.compress()
    packed_predict.launches = 0
    rows = X[:N_HIST_CASE]
    got = model.predict(rows, backend="cuda")
    want = model.predict(rows, backend="reference")
    err = float(np.abs(got - want).max())
    if packed_predict.launches < 1 or not err <= 1e-5:
        raise SystemExit(f"[train] served parity {err:.3e} with "
                         f"{packed_predict.launches} kernel launches")
    report = model.memory_report()
    print(f"[train] compressed: {report['encoded_stream_bytes']:.0f} B stream, "
          f"{report['compression_vs_f32']:.1f}x vs fp32 pointers; predict on "
          f"{len(rows)} rows through the cuda backend: parity {err:.2e} vs reference")
    return dict(launches=launches, fit_s=fit_s, rounds_s=rounds_s, n_trees=n_trees,
                n_splits=n_splits, toad_bytes=toad_bytes, accuracy=acc, **breakdown)


def profile_round(cfg, bins, y, edges) -> dict:
    """One boosting round under ``torch.profiler`` and the CUDA sync check:
    device time in the histogram kernels against all device time and the
    round's wall time; the round must not wait for the card once."""
    import dataclasses
    import time
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.gbdt import train

    one = dataclasses.replace(cfg, n_rounds=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            train(one, bins, y, edges)
        torch.cuda.set_sync_debug_mode(0)
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()]
    if syncs:
        raise SystemExit(f"[train] a round waited for the card {len(syncs)} time(s): "
                         f"{syncs[:3]}")
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0)) / 1e3
    total = sum(dev_ms(e) for e in on_card)
    hist = sum(dev_ms(e) for e in on_card if any(
        k in e.key for k in ("histogram_kernel", "channel_amax", "to_float_kernel")))
    n_ops = sum(e.count for e in on_card)
    if total <= 0:
        print(f"[train] one round: wall {wall * 1e3:.1f} ms, queued by the host after "
              f"{queued * 1e3:.1f} ms; the profiler recorded no device time "
              "(breakdown not measured); no waits for the card")
        return dict(round_wall_ms=wall * 1e3, round_queued_ms=queued * 1e3,
                    round_device_ms=None, round_hist_ms=None)
    print(f"[train] one round, profiled: wall {wall * 1e3:.1f} ms, queued by the host "
          f"after {queued * 1e3:.1f} ms; device busy {total:.1f} ms "
          f"({total / (wall * 1e3):.1%} of the wall), of which the histogram kernels "
          f"{hist:.1f} ms; {n_ops} device operations; no waits for the card")
    return dict(round_wall_ms=wall * 1e3, round_queued_ms=queued * 1e3,
                round_device_ms=total, round_hist_ms=hist)


def card_equals_cpu(dev) -> None:
    """The same small problem trained on the card and on the CPU grows the
    same trees (the card's machine has no JAX: the CPU stands in for it).

    Leaf values are held to rtol 1e-3: the CPU sums a leaf's rows in
    float32 in row order, and over ~10^4 rows of near-equal gradients that
    sum drifts by ~1e-4 relative (0.42 of -3938.22 on one 9,352-row leaf of
    this problem, against float64), while the card's fixed-point sums are
    exact to ~2^-47 a row.  The tree structure must be equal."""
    import dataclasses

    import torch

    from repro_torch.api import ToadModel
    from repro_torch.configs import get_gbdt_config

    cfg = dataclasses.replace(get_gbdt_config("toad_gbdt").gbdt, max_depth=6, n_rounds=2)
    X, y = draw_rows(5, 1 << 15, 256)
    card = ToadModel(config=cfg, n_bins=256, device=dev).fit(X, y).forest
    cpu = ToadModel(config=cfg, n_bins=256, device="cpu").fit(X, y).forest
    for k in ("feature", "thr_bin", "is_split", "leaf_ref", "n_trees", "n_leaf_values"):
        if not torch.equal(getattr(card, k).cpu(), getattr(cpu, k)):
            raise SystemExit(f"[card=cpu] {k} differs between the card and the CPU")
    got, want = card.leaf_values.cpu(), cpu.leaf_values
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30))[want != 0].max())
    if not torch.allclose(got, want, rtol=1e-3, atol=1e-5):
        raise SystemExit(f"[card=cpu] leaf values differ by {err:.3e} (relative {rel:.3e})")
    print(f"[card=cpu] n=32768, d=256, depth 6, 2 rounds: feature, thr_bin, is_split, "
          f"leaf_ref, n_trees, n_leaf_values equal ({int(cpu.n_trees)} trees, "
          f"{int(cpu.is_split.sum())} splits); leaf values max|Δ| {err:.3e}, "
          f"relative {rel:.3e} (the CPU's float32 row-order sums)")


def time_histogram(dev, smi: str, level: int) -> dict:
    """The kernel at one level's shape of the full-width fit (2^22 rows, 256
    features of 256 uint8 bins, column-major): level 0 builds one node;
    level 7 the left children of 64 parents (right rows' channels zeroed),
    beside the bound, the plain version and one ``index_add_`` call."""
    import torch

    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.ref import histogram_ref

    n, d, B = N_TRAIN, 256, 256
    gen = torch.Generator(device=dev).manual_seed(level)
    bins = torch.randint(0, B, (d, n), device=dev, generator=gen).to(torch.uint8).t()
    gh = torch.stack([0.5 * torch.randn(n, device=dev, generator=gen),
                      0.25 * torch.rand(n, device=dev, generator=gen),
                      torch.ones(n, device=dev)], -1)
    n_nodes = 1 if level == 0 else 2 ** (level - 1)
    child = torch.randint(0, 2 * n_nodes, (n,), device=dev, generator=gen)
    if level:
        gh = torch.where((child % 2 == 0)[:, None], gh, 0.0)
    pos = torch.div(child, 2, rounding_mode="floor").to(torch.int32)
    n_bytes, n_ops = histogram_work(bins, gh, pos, n_nodes, B)
    kernel = lambda: histogram(bins, gh, pos, n_nodes=n_nodes, n_bins=B)
    plain = lambda: histogram_ref(bins, gh, pos, n_nodes, B)
    runs = [("plain", _time_ms(plain, 2)), ("kernel", _time_ms(kernel, 5)),
            ("kernel", _time_ms(kernel, 5)), ("plain", _time_ms(plain, 2))]
    ms = float(np.mean([t for k, t in runs if k == "kernel"]))
    plain_ms = float(np.mean([t for k, t in runs if k == "plain"]))
    # the library call: index_add_ over prebuilt (node, feature, bin) ids
    ids = (pos.long()[:, None] * (d * B) + torch.arange(d, device=dev)[None, :] * B
           + bins.long()).reshape(-1)
    data = gh[:, None, :].expand(n, d, 3).reshape(-1, 3)
    out = torch.zeros((n_nodes * d * B, 3), device=dev)
    library_ms = _time_ms(lambda: out.index_add_(0, ids, data), 3)
    del ids, data, out
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[time] histogram level {level} ({n_nodes} node(s), n={n}, d={d}, {B} uint8 bins): "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in runs))
    print(f"[time] histogram level {level}: kernel {ms:.4f} ms/call, plain version "
          f"{plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; {n_bytes} B at 3.35 TB/s = {bytes_ms:.4f} ms; {n_ops} fp32 adds "
          f"at 67 TFLOP/s = {ops_ms:.4f} ms); kernel/bound {ms / bound_ms:.1f}x; card: {smi}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# ---- early-exit serving (kernel B3) -------------------------------------------

N_EE_TRAIN = 1 << 20  # rows of the 64-round fit: binning and fit stay near 30 s
EE_ROUNDS = 64  # the configuration's 8 rounds would leave one tree block to exit at


def check_early_exit_kernel(dev) -> float:
    """The early-exit kernel against its plain version on the card: scores,
    trees evaluated and exits equal to the bit, and two runs equal.
    Returns the largest |kernel - plain| over the scores (0.0 when equal)."""
    import torch

    from repro_torch.core.layout import decode, encode, to_packed
    from repro_torch.core.pipeline import probe_inputs
    from repro_torch.core.treeorder import remaining_mass
    from repro_torch.gbdt.forest import forest_from_numpy
    from repro_torch.kernels.ops import to_device
    from repro_torch.kernels.predict import device_exit_tables, packed_predict_early_exit

    guard = 1e-4  # the policy's default

    def model(arrays, C=1, shift=0.0):
        arrays = dict(arrays, base_score=arrays["base_score"] + np.float32(shift))
        forest = forest_from_numpy(arrays, C, device=dev)
        return forest, to_device(to_packed(decode(encode(forest))), dev)

    def rows(forest, n, seed, nan=0.0):
        x = probe_inputs(forest, n=n, seed=seed)
        x[np.random.default_rng(seed).random(x.shape) < nan] = np.nan
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    n = 65_536
    cases = []  # (label, model, rows, slack, min_trees)
    for T in (5, 8, 12):
        f, p = model(early_exit_forest(10 + T, n_trees=T))
        cases.append((f"T={T}, depth 8, d=256, n={n}", f, p, rows(f, n, T), 0.0, 0))
    f24, p24 = model(early_exit_forest(20, n_trees=24))
    x24 = rows(f24, n, 24)
    f_up, p_up = model(early_exit_forest(20, n_trees=24), shift=10.0)
    cases += [
        ("T=24, every row exits in block 0", f_up, p_up, x24, 0.0, 0),
        ("T=24, slack 1e9: no row ever exits", f24, p24, x24, 1e9, 0),
        ("T=24, min_trees=9: block 0's exit deferred", f_up, p_up, x24, 0.0, 9),
        ("T=24, 5% NaN inputs", f24, p24, rows(f24, n, 25, nan=0.05), 0.0, 0),
    ]
    fm, pm = model(early_exit_forest(21, n_trees=27, n_ensembles=3), C=3)
    cases.append(("multiclass C=3, T=27, 1% NaN", fm, pm, rows(fm, n, 27, nan=0.01), 0.0, 0))
    fz, pz = model(early_exit_forest(22, n_trees=32, n_used_features=0))
    cases.append(("zero-split |F_U|=0, T=32", fz, pz, rows(fz, 4096, 32), 0.0, 0))
    fg, pg = model(early_exit_forest(23, n_trees=64))
    staged = 4 * (2 * pg.used_features.numel() + 1 + pg.thr_table.numel()
                  + pg.leaf_values.numel())
    if staged <= 48 * 1024:
        raise SystemExit(f"[ee-kernel] the T=64 model stages {staged} B, inside the cap")
    cases.append((f"T=64, {staged} B of tables read from global memory", fg, pg,
                  rows(fg, n, 64, nan=0.01), 0.0, 0))
    cases += [(f"T=24, n={m}", f24, p24, x24[:m], 0.0, 0) for m in (1, 255, 257)]

    max_err = 0.0
    for label, forest, p, x, slack, min_trees in cases:
        C = p.n_ensembles
        bound = remaining_mass(forest)
        T = p.words.shape[0]
        tables = device_exit_tables(bound, np.full(C, slack), n_trees=T, n_ensembles=C,
                                    min_trees=min_trees, device=x.device)
        before = packed_predict_early_exit.launches
        # the bound on the host, then the tables made once, as serving does
        got = packed_predict_early_exit(x, *p.arrays(), bound, np.full(C, slack),
                                        **p.meta(), guard=guard, min_trees=min_trees)
        again = packed_predict_early_exit(x, *p.arrays(), **p.meta(), guard=guard,
                                          tables=tables)
        want = _ee_plain(x, p, tables, guard)
        torch.cuda.synchronize()
        if packed_predict_early_exit.launches != before + 2:
            raise SystemExit(f"[ee-kernel] {label}: the kernel did not launch")
        if got[0].shape != (x.shape[0], C) or not torch.isfinite(got[0]).all():
            raise SystemExit(f"[ee-kernel] {label}: bad output {tuple(got[0].shape)}")
        err = float((got[0] - want[0]).abs().max())
        max_err = max(max_err, err)
        for name, a, b, c in zip(("scores", "trees", "exited"), got, want, again):
            if not torch.equal(a, b):
                raise SystemExit(f"[ee-kernel] {label}: {name} differ from the plain version")
            if not torch.equal(a, c):
                raise SystemExit(f"[ee-kernel] {label}: two runs differ in {name}")
        trees, exited = got[1], got[2]
        print(f"[ee-kernel] {label}: scores, trees and exits equal to the plain version "
              f"to the bit, two runs (host bound, tables made once) equal; mean trees {float(trees.float().mean()):.3f} "
              f"of {T}, {float(exited.float().mean()):.1%} exited")
    # a zero-tree model: the base scores, no launch
    fz0, pz0 = model(synthetic_forest(3, n_trees=0))
    x0 = rows(fz0, 100, 0)
    before = packed_predict_early_exit.launches
    s, t, e = packed_predict_early_exit(x0, *pz0.arrays(), remaining_mass(fz0), [0.0],
                                        **pz0.meta(), guard=guard)
    if (packed_predict_early_exit.launches != before or t.any() or e.any()
            or not torch.equal(s, pz0.base_score[None, :].expand(100, 1))):
        raise SystemExit("[ee-kernel] the zero-tree model launched or changed its base")
    print("[ee-kernel] zero-tree T=0: the base scores, no launch")
    return max_err


def early_exit_full_width(dev, smi: str, tmp: str) -> dict:
    """The early-exit serving path at the full width of ``toad_gbdt``:
    ``ToadModel.fit`` on the card for 64 rounds, compressed exactly, then
    262,144 held-out rows through ``predict_packed_model_early_exit`` with
    ``EarlyExitPolicy(epsilon=0)``, held against B1's full evaluation."""
    import dataclasses
    import time
    import warnings

    import torch

    from repro_torch.api import EarlyExitPolicy, ToadModel
    from repro_torch.configs import get_gbdt_config
    from repro_torch.core.treeorder import remaining_mass
    from repro_torch.kernels.ops import predict_packed_model, predict_packed_model_early_exit
    from repro_torch.kernels.predict import (
        device_exit_tables,
        packed_predict_early_exit,
        tree_block_for,
    )

    wl = get_gbdt_config("toad_gbdt")
    cfg = dataclasses.replace(wl.gbdt, n_rounds=EE_ROUNDS)
    print(f"[ee] cuts: rows {wl.rows} -> {N_EE_TRAIN} (binning and the fit near 30 s); "
          f"rounds {wl.gbdt.n_rounds} -> {EE_ROUNDS} ({EE_ROUNDS // 8} tree blocks to "
          "exit between)")
    X, y = draw_rows(7, N_EE_TRAIN, wl.n_features)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = ToadModel(config=cfg, n_bins=wl.n_bins, device=dev).fit(X, y).compress()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    T = int(model.forest.n_trees)
    Xh, yh = draw_rows(8, N_FULL, wl.n_features)
    print(f"[ee] fit {N_EE_TRAIN} x {wl.n_features}, {cfg.n_rounds} rounds of depth "
          f"{cfg.max_depth}: {fit_s:.3f} s, {T} trees; held-out accuracy "
          f"{model.score(Xh, yh):.4f}")
    if T < 2 * tree_block_for(1):
        raise SystemExit(f"[ee] the fit kept {T} trees: too few blocks to exit between")
    policy = EarlyExitPolicy(epsilon=0.0)
    bound = remaining_mass(model.forest)
    dp = model.device_packed()
    xt = torch.from_numpy(Xh).to(dev)
    torch.cuda.synchronize()
    packed_predict_early_exit.launches = 0
    # the rows already on the card: the call itself must not wait for it
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        scores, trees, exited = predict_packed_model_early_exit(
            dp, xt, bound, policy.slack(1), guard=policy.guard,
            min_trees=policy.min_trees, device=dev)
    torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()]
    full = predict_packed_model(dp, xt, device=dev)
    torch.cuda.synchronize()
    if packed_predict_early_exit.launches != 1 or syncs:
        raise SystemExit(f"[ee] launches {packed_predict_early_exit.launches}, waits for "
                         f"the card {syncs[:3]}")
    tables = device_exit_tables(bound, policy.slack(1), n_trees=T, n_ensembles=1,
                                min_trees=policy.min_trees, device=dev)
    for name, a, b in zip(("scores", "trees", "exited"), (scores, trees, exited),
                          _ee_plain(xt, dp, tables, policy.guard)):
        if not torch.equal(a, b):
            raise SystemExit(f"[ee] the served model's {name} differ from the plain version")
    mism = int(((scores[:, 0] > 0) != (full[:, 0] > 0)).sum())
    tb = tree_block_for(1)
    on_blocks = bool(((trees[exited] % tb) == 0).all()) and bool((trees[~exited] == T).all())
    ne = ~exited
    ne_err = float((scores[ne] - full[ne]).abs().max()) if bool(ne.any()) else 0.0
    mean_trees = float(trees.float().mean())
    share = float(exited.float().mean())
    print(f"[ee] n={N_FULL} held-out rows, EarlyExitPolicy(epsilon=0), guard "
          f"{policy.guard}, one launch and no wait for the card: label mismatches vs B1's full evaluation {mism}; mean trees "
          f"evaluated {mean_trees:.4f} of {T}; {share:.4%} exited; scores, trees and exits "
          f"equal to the plain version to the bit; every exit on a multiple "
          f"of tree_block={tb}: {on_blocks}; non-exited rows ({int(ne.sum())}) max|Δ| to "
          f"B1 {ne_err:.3e}")
    if mism or not on_blocks or not ne_err <= 1e-6:
        raise SystemExit("[ee] the full-width early-exit run broke its contract")
    del xt
    path = model.save(f"{tmp}/ee.toad")
    times = time_early_exit(dev, smi, dp, tables, policy, Xh)
    return dict(path=path, n_trees=T, fit_s=fit_s, mean_trees=mean_trees, share=share,
                **times)


def time_early_exit(dev, smi, dp, tables, policy, Xh) -> dict:
    """B3 beside B1 and the plain version at n = 262,144 and at the engine's
    256-row bucket, in turns, given the exit tables made once as serving
    does; B3's bytes bound over the trees each row evaluates."""
    import torch

    from repro_torch.kernels.predict import packed_predict, packed_predict_early_exit

    out = {}
    for n, reps, plain_reps in ((256, 50, 3), (N_FULL, 20, 2)):
        xt = torch.from_numpy(Xh[:n]).to(dev)
        ee = lambda: packed_predict_early_exit(
            xt, *dp.arrays(), **dp.meta(), guard=policy.guard,
            max_feature=dp.max_feature, tables=tables)
        b1 = lambda: packed_predict(xt, *dp.arrays(), **dp.meta(), max_feature=dp.max_feature)
        plain = lambda: _ee_plain(xt, dp, tables, policy.guard)
        runs = [("plain", _time_ms(plain, plain_reps)), ("kernel", _time_ms(ee, reps)),
                ("B1", _time_ms(b1, reps)), ("kernel", _time_ms(ee, reps)),
                ("B1", _time_ms(b1, reps)), ("plain", _time_ms(plain, plain_reps))]
        ms = float(np.mean([t for k, t in runs if k == "kernel"]))
        b1_ms = float(np.mean([t for k, t in runs if k == "B1"]))
        plain_ms = float(np.mean([t for k, t in runs if k == "plain"]))
        scores, trees, exited = ee()
        n_bytes, n_ops, path_scores = needed_work(dp, xt, trees)
        if not torch.allclose(path_scores, scores, rtol=1e-5, atol=1e-5):
            raise SystemExit(f"[time] B3 n={n}: the counted paths are not the kernel's")
        n_bytes += 4 * n + sum(4 * t.numel() for t in tables)  # exit written; the tables
        n_ops += 8 * int((trees + 7).div(8, rounding_mode="floor").sum())  # exit checks
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"[time] B3 n={n}, T={dp.words.shape[0]}, depth {dp.max_depth}: "
              + ", ".join(f"{k} {t:.4f} ms" for k, t in runs))
        print(f"[time] B3 n={n}: kernel {ms:.4f} ms/call, B1 on the same model and rows "
              f"{b1_ms:.4f} ms, plain version {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; bytes the rows' evaluated paths need {n_bytes} B at 3.35 TB/s "
              f"= {bytes_ms:.4f} ms; fp32 ops {n_ops} at 67 TFLOP/s = {ops_ms:.4f} ms); "
              f"kernel/bound {ms / bound_ms:.1f}x; mean trees {float(trees.float().mean()):.3f}; "
              f"library: none — no single PyTorch call computes this function; card: {smi}")
        out[n] = dict(ms=ms, b1_ms=b1_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)
        del xt
    return dict(ms=out[N_FULL]["ms"], plain_ms=out[N_FULL]["plain_ms"],
                bound_ms=out[N_FULL]["bound_ms"], bound_by=out[N_FULL]["bound_by"],
                b1_ms=out[N_FULL]["b1_ms"], ms_256=out[256]["ms"])


def _ee_plain(xt, dp, tables, guard):
    """The early-exit kernel's plain version on the card's tensors and the
    exit tables its wrapper takes; returns ``(scores, trees, exited)``."""
    from repro_torch.kernels.predict import tree_block_for
    from repro_torch.kernels.ref import packed_predict_early_exit_ref

    T = dp.words.shape[0]
    scores, exit_at = packed_predict_early_exit_ref(
        xt, *dp.arrays(), *tables, **dp.meta(), tree_block=tree_block_for(dp.n_ensembles),
        guard=float(np.float32(guard)))
    return scores, exit_at.clamp(max=T), exit_at < T


def main() -> int:
    import json
    import subprocess
    import tempfile
    import time

    import torch

    t_start = time.perf_counter()
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"[device] {kind}, capability {torch.cuda.get_device_capability(0)}, "
          f"count {count}; nvidia-smi: {smi}")

    # ---- 2. build --------------------------------------------------------
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"[ptxas -v] {name}.cu\n{log.rstrip()}")
    used = [ln.split("info    :")[-1].strip() for log in logs.values()
            for ln in log.splitlines() if "Used" in ln]
    print(f"[build] {len(_build.sources())} source(s) in {build_s:.2f} s; "
          f"ptxas: {'; '.join(used) or 'cached build, no ptxas output'}")

    # ---- 3. kernel vs plain version on the card ----------------------------
    from repro_torch.core.layout import decode, encode, to_packed
    from repro_torch.core.pipeline import probe_inputs
    from repro_torch.gbdt.forest import forest_from_numpy
    from repro_torch.kernels.ops import to_device
    from repro_torch.kernels.predict import packed_predict
    from repro_torch.kernels.ref import packed_predict_ref

    def on_card(arrays, n_ensembles=1):
        forest = forest_from_numpy(arrays, n_ensembles, device=dev)
        return forest, to_device(to_packed(decode(encode(forest))), dev)

    full_forest, full = on_card(synthetic_forest(0))
    x_full = probe_inputs(full_forest, n=N_FULL, seed=1)
    x_full[np.random.default_rng(2).random(x_full.shape) < 0.01] = np.nan
    # the same trees over a 16,384-value leaf table: the small tables pass the
    # kernel's 48 KB staging cap, so it reads them from global memory
    _, wide = on_card(synthetic_forest(0, n_leaf_values=16_384))
    wide_stage = 4 * (2 * wide.used_features.numel() + 1 + wide.thr_table.numel()
                      + wide.leaf_values.numel())
    if wide_stage <= 48 * 1024:
        raise SystemExit(f"[kernel] the wide-table model stages {wide_stage} B, "
                         "inside the cap: it would not drive the global variant")
    mc_forest, mc = on_card(synthetic_forest(
        1, n_trees=21, max_depth=4, n_ensembles=3, n_used_features=24), 3)
    zs_forest, zs = on_card(synthetic_forest(2, n_trees=32, n_used_features=0))
    zt_forest, zt = on_card(synthetic_forest(3, n_trees=0))
    cases = [
        (f"full width d=256 depth 8 T=256, n={N_FULL}, 1% NaN", full, x_full),
        ("multiclass C=3 T=21 depth 4", mc, probe_inputs(mc_forest, n=1000, seed=3)),
        ("zero-split |F_U|=0", zs, probe_inputs(zs_forest, n=1000, seed=4)),
        ("zero-tree T=0", zt, probe_inputs(zt_forest, n=1000, seed=5)),
        (f"full width, 16,384 leaf values ({wide_stage} B of tables, read from "
         f"global memory), n={N_FULL}, 1% NaN", wide, x_full),
    ] + [(f"full width n={n}", full, x_full[:n]) for n in (1, 255, 257)]
    max_abs_err = 0.0
    for label, p, x in cases:
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        got = packed_predict(xt, *p.arrays(), **p.meta())
        want = packed_predict_ref(xt, *p.arrays(), **p.meta())
        torch.cuda.synchronize()
        if got.shape != (x.shape[0], p.n_ensembles) or not torch.isfinite(got).all():
            raise SystemExit(f"[kernel] {label}: bad output {tuple(got.shape)}")
        err = float((got - want).abs().max())
        max_abs_err = max(max_abs_err, err)
        # same per-column summation order as the plain version: equal to the bit
        if not torch.equal(got, want):
            raise SystemExit(f"[kernel] {label}: differs from the plain version "
                             f"(max|Δ| {err:.3e})")
        print(f"[kernel] {label}: equal to the plain version to the bit")
    hist_err = check_histogram_kernel(dev)
    ee_err = check_early_exit_kernel(dev)

    # ---- 4. serve: the port's main path ------------------------------------
    from repro_torch.api import ToadModel
    from repro_torch.gbdt.trainer import GBDTConfig
    from repro_torch.launch import serve

    # the toad_gbdt configuration's knobs, with one round per synthetic tree
    config = GBDTConfig(task="binary", n_rounds=256, max_depth=8, learning_rate=0.1,
                        toad_penalty_feature=8.0, toad_penalty_threshold=2.0,
                        leaf_capacity=8192)
    with tempfile.TemporaryDirectory() as tmp:
        path = ToadModel.from_forest(full_forest, config, n_bins=256, device=dev) \
            .compress().save(f"{tmp}/m.toad")
        packed_predict.launches = 0
        served = serve.main(["--arch", "toad-gbdt", "--model", path,
                             "--backend", "cuda", "--requests", "2048",
                             "--clients", "4"])
        launches = packed_predict.launches
    if served["backend"] != "cuda" or launches < served["n_batches"]:
        raise SystemExit(f"[serve] the kernel ran {launches} time(s) for "
                         f"{served['n_batches']} batches on {served['backend']}")
    print(f"[serve] {served['n_requests']} requests in {served['n_batches']} "
          f"batches, {served['req_per_s']:.1f} req/s, parity "
          f"{served['max_abs_err']:.2e}; packed_predict launches {launches}")

    # ---- 4b. train: the port's main training path, then the CLI's ---------
    from repro_torch.kernels.histogram import histogram

    trained = train_full_width(dev, smi)
    card_equals_cpu(dev)
    histogram.launches = 0
    packed_predict.launches = 0
    served_t = serve.main(["--arch", "toad-gbdt", "--backend", "cuda"])
    if histogram.launches < 1 or packed_predict.launches < served_t["n_batches"]:
        raise SystemExit(f"[serve+train] histogram ran {histogram.launches}, "
                         f"packed_predict {packed_predict.launches} time(s)")
    print(f"[serve+train] in-process training, then {served_t['n_requests']} requests, "
          f"parity {served_t['max_abs_err']:.2e}; histogram launches "
          f"{histogram.launches}, packed_predict launches {packed_predict.launches}")

    # ---- 4c. early-exit serving: the entry point, then the serve CLI -------
    from repro_torch.kernels.predict import packed_predict_early_exit

    with tempfile.TemporaryDirectory() as tmp:
        ee = early_exit_full_width(dev, smi, tmp)
        packed_predict_early_exit.launches = 0
        served_ee = serve.main(["--arch", "toad-gbdt", "--model", ee["path"],
                                "--backend", "cuda", "--early-exit", "0",
                                "--requests", "2048", "--clients", "4"])
        ee_launches = packed_predict_early_exit.launches
    if served_ee["label_mismatches"] != 0 or ee_launches < served_ee["n_batches"]:
        raise SystemExit(f"[serve-ee] {served_ee['label_mismatches']} label mismatches, "
                         f"{ee_launches} kernel launches for {served_ee['n_batches']} batches")
    print(f"[serve-ee] {served_ee['n_requests']} requests through --backend cuda "
          f"--early-exit 0: {served_ee['req_per_s']:.1f} req/s, p50 "
          f"{served_ee['latency_p50_ms']:.2f} ms, p95 {served_ee['latency_p95_ms']:.2f} ms, "
          f"mean trees evaluated {served_ee['mean_trees_evaluated']:.3f} of {ee['n_trees']}, "
          f"exact-label mismatches 0; packed_predict_early_exit launches {ee_launches}")

    # ---- 5. time: plain, kernel, kernel, plain ----------------------------
    T, I = full.words.shape
    D, C = full.max_depth, full.n_ensembles

    def timed(n, kernel_reps, plain_reps):
        xt = torch.from_numpy(x_full[:n]).to(dev)
        kernel = lambda: packed_predict(xt, *full.arrays(), **full.meta())
        plain = lambda: packed_predict_ref(xt, *full.arrays(), **full.meta())
        runs = [("plain", _time_ms(plain, plain_reps)),
                ("kernel", _time_ms(kernel, kernel_reps)),
                ("kernel", _time_ms(kernel, kernel_reps)),
                ("plain", _time_ms(plain, plain_reps))]
        kernel_ms = float(np.mean([t for k, t in runs if k == "kernel"]))
        plain_ms = float(np.mean([t for k, t in runs if k == "plain"]))
        n_bytes, n_ops, path_scores = needed_work(full, xt)
        if not torch.allclose(path_scores, kernel(), rtol=1e-5, atol=1e-5):
            raise SystemExit(f"[time] n={n}: the counted paths are not the kernel's")
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"[time] n={n}, T={T}, depth {D}, d={xt.shape[1]}: "
              + ", ".join(f"{k} {t:.4f} ms" for k, t in runs))
        print(f"[time] n={n}: kernel {kernel_ms:.4f} ms/call "
              f"({n / kernel_ms * 1e3:.4g} rows/s), plain version {plain_ms:.3f} "
              f"ms/call, bound {bound_ms:.4f} ms ({bound_by}; bytes the rows' "
              f"paths need {n_bytes} B at 3.35 TB/s = {bytes_ms:.4f} ms; fp32 "
              f"ops {n_ops} at 67 TFLOP/s = {ops_ms:.4f} ms); kernel/bound "
              f"{kernel_ms / bound_ms:.1f}x; library: none — no single PyTorch "
              f"call computes this function; card: {smi}")
        return kernel_ms, plain_ms, bound_ms, bound_by, xt

    # the engine's largest bucket (the batch the serving path launches on),
    # then the large batch
    timed(256, 50, 3)
    kernel_ms, plain_ms, bound_ms, bound_by, xt = timed(N_FULL, 20, 3)
    # the same trees with the tables staged (4,096 leaf values) and read from
    # global memory (16,384), in turns
    staged = lambda: packed_predict(xt, *full.arrays(), **full.meta())
    unstaged = lambda: packed_predict(xt, *wide.arrays(), **wide.meta())
    runs = [("staged", _time_ms(staged, 20)), ("global", _time_ms(unstaged, 20)),
            ("global", _time_ms(unstaged, 20)), ("staged", _time_ms(staged, 20))]
    print(f"[time] n={N_FULL}, tables staged in shared memory vs read from "
          "global memory: " + ", ".join(f"{k} {t:.4f} ms" for k, t in runs))
    del xt, staged, unstaged
    level0 = time_histogram(dev, smi, 0)
    time_histogram(dev, smi, 7)

    # ---- 6. kernels line, card line, last line ----------------------------
    print(json.dumps({"kernels": [{
        "name": "packed_predict",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/packed_predict.cu",
        "replaces": "src/repro/kernels/predict.py:55",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "histogram",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/histogram.cu",
        "replaces": "src/repro/kernels/histogram.py:48",
        "launches": trained["launches"],
        "max_abs_err": hist_err,
        **level0,
    }, {
        "name": "packed_predict_early_exit",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/packed_predict_ee.cu",
        "replaces": "src/repro/kernels/predict.py:197",
        "launches": ee_launches,
        "max_abs_err": ee_err,
        "ms": ee["ms"],
        "plain_ms": ee["plain_ms"],
        "bound_ms": ee["bound_ms"],
        "bound_by": ee["bound_by"],
        "library_ms": None,
    }]}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
