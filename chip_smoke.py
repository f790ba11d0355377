#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version on the card, serves a full-width model
through the port's own entry points, times the kernel beside its bound and
ends with one JSON line.  It needs a card: without CUDA it fails at once.
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


# published peaks of one H100 SXM (the card's data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_FULL = 262_144  # rows of the full-width kernel case and of the timing


def needed_work(p, x):
    """What packed inference of the rows ``x`` needs of the card, counted
    along each row's real paths through the model ``p`` (a ``DevicePacked``
    with at least one used feature).

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
    idx = torch.zeros((n, T), dtype=torch.long, device=x.device)
    node_seen = torch.zeros(T * I, dtype=torch.bool, device=x.device)
    pair_seen = torch.zeros((n, n_fu + 1), dtype=torch.bool, device=x.device)
    compares = 0
    for _ in range(p.max_depth):
        node = roots + idx
        node_seen[node] = True
        w = words.view(-1)[node]
        ref = (w >> p.tidx_bits).clamp(max=n_fu)  # n_fu: unsplit, reads no x
        split = ref < n_fu
        compares += int(split.sum())
        pair_seen.scatter_(1, ref, True)
        k = (off[ref] + (w & tmask)).clamp(0, thr.numel() - 1)
        right = split & ~(torch.gather(x, 1, uf[ref]) <= thr[k])
        idx = 2 * idx + 1 + right.long()
    leaf = torch.arange(T, device=x.device) * (I + 1) + idx - I
    leaf_seen = torch.zeros(T * (I + 1), dtype=torch.bool, device=x.device)
    leaf_seen[leaf] = True
    values = p.leaf_values[p.leaf_ref.view(-1)[leaf].long()]
    scores = p.base_score[None, :].expand(n, C).clone()
    scores.index_add_(1, torch.arange(T, device=x.device) % C, values)
    tables = sum(a.numel() for a in (p.leaf_values, p.thr_table, p.thr_offsets,
                                     p.used_features, p.base_score))
    n_bytes = 4 * (int(pair_seen[:, :n_fu].sum()) + int(node_seen.sum())
                   + int(leaf_seen.sum()) + tables + n * C)
    return n_bytes, compares + n * T, scores


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
    }]}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
