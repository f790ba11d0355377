#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` each, all started together), holds each against its plain PyTorch
version on the card (the two inference kernels on cases that take every
variant of their launch plan, printed with each case; the trainer's
per-level commit to the bit on ``COMMIT_CASES``, then timed at each level's
shape of the full-width fit), then drives the
port's main paths through its own
entry points: serving a full-width model (``packed_predict``), training one
at the full width of ``toad_gbdt`` on 2^22 rows (``histogram``) and serving
it, trees trained on the card against trees trained on the CPU, the serve
CLI training in-process, binning the training rows through
``ops.apply_binning`` (``binning``) against the trainer's ``apply_bins``,
label-exact early-exit serving of a 64-round full-width model
(``packed_predict_early_exit``) through its entry point and through the
serve CLI, and that model compressed under a byte budget (the ladder, an
accuracy floor, the same stream from a CPU copy), saved and toadchecked,
loaded and served through the serve CLI, with a corrupted copy refused.
Serving's host work per engine batch is split step by step.  Slice 5
(resilience): the serve CLI under a policy with nothing faulted (the
kernel serves every batch), a ``GBDTEngine`` whose ``cuda`` backend is
faulted until its breaker opens (``packed`` serves on the card) and then
returns to the kernel, and a worker crash its supervisor restarts.  Slice
6 (streaming): the 256-tree model saved as a ``.toadpack`` (32 blocks,
deep-verified, the CPU's bytes), scored progressively on the card over
262,144 rows until it equals B1, ``feed_until_confident`` on the
early-exit model, and a corrupted and a truncated pack refused.  Slice 7
(the fleet): 20 full-width artifacts (5 forests along a 4-rung ladder, two
also as packs) and an early-exit fleet of 20, built on host processes;
admission (``python -m repro_torch.launch.fleet --dry-run``) and a
corrupted directory refused; the shared tables as one card tensor and the
card memory they save; routed traffic through the fleet CLI and the serve
CLI (B1, a hot swap, streaming); the LRU and a swap's drain; early exit
over a fleet (B3); an admit fault, one model's breaker and a worker
restart.  Slice 8 (the paper's baselines, data-parallel training), on the
training phase's rows, bins and fit: CEGB through B2 (its trees on the
card equal the CPU's), CCP pruning served through B1, the quantized and
shared-table layouts, a 32-tree random forest through B2 with
margin&diversity ordering; then 4 ranks on the one card (gloo), spawned by
``gbdt.distributed.spawn_data_parallel``, every rank's histograms through
B2, the trees equal to the single-process fit, round 0's level-0 reduced
histogram held to one process's, quantized collectives at 16 bits within
0.02 accuracy and at 8 bits inside the bands of their readings.  Slice 9
(the LM serving path, ``[lm]``; no kernel of the repo is on it): the 7
reduced transformer-family configs on the card against the port's CPU
path, qwen3-4b at full width and depth through the serve CLI (its decode
against fresh prefills, its int8 cache against bf16, a profiled decode
step), and olmoe-1b-7b at full width and depth (finite logits, dropped
routed slots).  Slice 10 (``[lm]`` too): the reduced rwkv6, recurrentgemma
and whisper configs on the card against the CPU (on ``init``'s weights
and with the constant entries redrawn); rwkv6-1.6b, recurrentgemma-9b
(B=4 at prompt 512, then B=1 at 2,560, past the 2,048 window) and
whisper-small at full width and depth through the serve CLI, each with
its decode step's bytes bound, a profiled decode (and rwkv6's sequential
prefill), and its first bf16 decode steps against fresh prefills (rwkv6's
also with every product and row reduction run at the prefill's rows,
where they must be equal).  Slice 11 (LM training, ``[lm-train]``; no
kernel of the repo on it): the 10 reduced configs' training step on the
card against the CPU path on the same float32 masters (loss, every
gradient leaf, one optimizer update on the same gradients;
``grad_dtype="bf16"`` on one), rwkv6-1.6b trained at full width and depth
through the training CLI's ``main`` (B=8, S=64, 10 AdamW steps, the loss
decreasing, ms a step, peak memory, one profiled step), and a crash and
resume on the card ending on the uninterrupted run's parameters.  Slice
12 (the launch tooling, ``[dryrun]``; no kernel of the repo on it):
qwen3-4b's decode step and rwkv6-1.6b's training step at full width
traced on the meta device through ``launch.dryrun`` and run on the card:
the FLOPs equal, the argument bytes what placing the arguments as the
training and serving CLIs place them adds to ``memory_allocated``, the
card's peak inside a band of the trace's,
and the achieved rates.  Slice 13 (the transformer family on a (data,
model) mesh, ``[lm-mesh]``; no kernel of the repo on it): qwen3-4b at
full width and depth on one card, then on a (1, 4) mesh of 4 gloo ranks
sharing the card, fed the one-card run's tokens, its logits held to the
one card's; the reduced olmoe-1b-7b on (2, 2), each rank on the card
against the same rank on the CPU, the kept MoE slots equal.  Slice 14
(``[lm-mesh]`` too): rwkv6-1.6b (also cut to 2 layers), whisper-small and
recurrentgemma-9b at full width on one card, then on the same (1, 4) mesh,
fed the one-card runs' tokens and held to them; the reduced rwkv6 (one row,
whole on every rank: ``long_500k``'s form), recurrentgemma (past its
window) and whisper on (2, 2), each rank on the card against the same
rank on the CPU.  Slices 15-16 (LM training on a (data, model) mesh,
``[lm-mesh-train]``; no kernel of the repo on it): qwen3-4b, rwkv6-1.6b
and whisper-small at full width on a (2, 2) mesh and recurrentgemma-9b on
(1, 4), each against one card's steps (the loss and every leaf's
gradient shard); five reduced configs on (2, 2), each rank on the card
against the same rank on the CPU; a meshed checkpoint resumed and restored
onto another mesh.  A ``[clock]`` line ends each phase.
Times each kernel beside its bound, its plain version and, where one
exists, a PyTorch call computing the same function (the histogram at the
nine calls of a full-width tree, levels 1-7 both with right rows dropped,
the trainer's form, and with their channels zeroed, each call's output
also held to the plain version in float64), and ends with one JSON line.
It needs a card: without CUDA it fails at once.
"""

from __future__ import annotations

import contextlib
import os
import platform
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


#: cycles the card sleeps (~0.1 s) while the host queues the calls a
#: ``queued`` timing measures
QUEUE_SLEEP_CYCLES = 200_000_000


def _time_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call.  ``queued``: the card first sleeps ~0.1 s while
    the host queues the calls, so the events time them back to back on the
    card even where the host takes longer to issue a call than the card to
    run it (a small batch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int) -> float:
    """Mean host-clock time of ``fn`` over ``reps`` calls, synchronised at
    the end: a wrapper's cost per call where the card runs it faster."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def check_variants_driven(tag: str, plans, early_exit: bool) -> None:
    """Fail unless the ``plans`` of a phase's cases take every variant: each
    part staged in some case and read from global memory in another, the
    128- and 32-row tiles, and for B1 both grids."""
    from repro_torch.kernels.predict import STAGE_NAMES

    missing = [f"{name} {how}" for bit, name in STAGE_NAMES
               for how, seen in (("staged", any(p.stage & bit for p in plans)),
                                 ("global", any(not p.stage & bit for p in plans)))
               if not seen]
    missing += [f"{r}-row tiles" for r in (32, 128) if r not in {p.rows for p in plans}]
    if not early_exit:
        missing += [g for g, seen in (("split grid", any(p.split for p in plans)),
                                      ("unsplit grid", any(not p.split for p in plans)),
                                      ("groups of several tree blocks",
                                       any(p.per_group > 1 and p.split for p in plans)))
                    if not seen]
    if missing:
        raise SystemExit(f"[{tag}] no case takes: {', '.join(missing)}")
    print(f"[{tag}] the cases take every variant of the launch plan")


def plan_of(dev, n: int, early_exit: bool = False):
    """The launch plan the packed-inference wrappers take for ``n`` rows
    through the model ``dev``."""
    from repro_torch.kernels.predict import launch_plan

    T, I = dev.words.shape
    return launch_plan(n, T, I, dev.n_ensembles, dev.used_features.numel(),
                       early_exit=early_exit)


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


def histogram_work(bins, gh, pos, n_nodes: int, n_bins: int, kept_only: bool = False):
    """What one histogram call needs of the card: each input read once (bins
    at their storage width, gh, pos), the output written once; one fp32 add
    per (kept row, feature, channel).  ``kept_only``: the bins and channels
    of rows outside ``[0, n_nodes)`` are not needed (the trainer's call with
    right rows dropped); pos is read whole.  Returns ``(n_bytes, n_ops)``."""
    n, d = bins.shape
    CH = gh.shape[1]
    kept = int(((pos >= 0) & (pos < n_nodes)).sum())
    rows = kept if kept_only else n
    n_bytes = (rows * (d * bins.element_size() + CH * 4) + pos.numel() * 4
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
    # the trainer's row-major layout (a row's 32 features in two 16-byte loads)
    cases += [(f"row-major full width d=256, 256 bins, n={N}, {k} node(s)",
               tuple(t.contiguous() for t in inputs(N, 256, 256, k)), k, 256) for k in (1, 64)]
    wide, gh48, pos48 = (t.contiguous() for t in inputs(N, 48, 256, 6, oob=True))
    cases += [
        ("d=33 of a row-major (n, 48): one group of 32 in two loads, one of 1 loaded "
         "bin by bin", (wide[:, :33], gh48, pos48), 6, 256),
        (f"leaf call: d=1, one bin, 256 nodes, n={N}",
         (torch.zeros((N, 1), dtype=torch.uint8, device=dev), *inputs(N, 1, 1, 257)[1:]),
         256, 1),
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
    # the trainer's call drops right rows (pos -1); zeroing their channels
    # instead gives the same cells, the same bits
    rows = bins.contiguous()
    left = child % 2 == 0
    dropped = histogram(rows, gh, torch.where(left, parent, -1), n_nodes=32, n_bins=256)
    zeroed = histogram(rows, torch.where(left[:, None], gh, 0.0), parent, n_nodes=32,
                       n_bins=256)
    torch.cuda.synchronize()
    if not torch.equal(dropped, zeroed):
        raise SystemExit("[hist] right rows dropped and right rows zeroed differ")
    print("[hist] 32 parents' left children, right rows dropped (pos -1) vs their "
          "channels zeroed: equal to the bit")
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


# ---- the trainer's per-level commit (kernels/commit.py) ----------------------

#: a level's commit cases (``commit_inputs``' arguments): the fit's widths at
#: 1 and 128 nodes, covtype's, d * E off the cluster's 8,192 threads (and off
#: 4, where the kernel reads candidate by candidate), ties, nodes with no valid
#: candidate, dead nodes, NaN gains, a CEGB cost, used sets half set, and
#: used sets too large for shared memory (kept in device memory)
COMMIT_CASES = {
    "256x255-1-node": dict(n_nodes=1, d=256, E=255),
    "256x255-128-nodes": dict(n_nodes=128, d=256, E=255),
    "54x63": dict(n_nodes=8, d=54, E=63),
    "ragged-1031": dict(n_nodes=5, d=1, E=1031),
    "ragged-quads-1044": dict(n_nodes=3, d=12, E=87),
    "ties-everywhere": dict(n_nodes=16, d=8, E=15, ties=True),
    "ties-planted": dict(n_nodes=8, d=32, E=31, planted=True),
    "no-valid-candidate": dict(n_nodes=6, d=16, E=31, no_valid=(1, 4)),
    "dead-nodes": dict(n_nodes=16, d=16, E=31, dead=0.5),
    "nan-gains": dict(n_nodes=8, d=16, E=31, nan=True),
    "cegb": dict(n_nodes=16, d=32, E=63, cegb=4.0, n_rows=6001),
    "cegb-at-cost": dict(n_nodes=16, d=32, E=63, cegb=4.0, n_rows=6001, at_cost=True),
    "half-used": dict(n_nodes=32, d=64, E=63, used=0.5),
    "sets-in-device-memory": dict(n_nodes=2, d=1024, E=255),
    "sets-in-device-memory-1021x211": dict(n_nodes=2, d=1021, E=211),
}


def commit_inputs(dev, n_nodes: int, d: int, E: int, seed: int = 0, *, pen=(8.0, 2.0),
                  cegb: float = 0.0, n_rows: int = 1 << 20, used: float = 0.0,
                  ties: bool = False, planted: bool = False, no_valid=(), dead: float = 0.0,
                  nan: bool = False, at_cost: bool = False):
    """One level's arguments to ``kernels.commit.commit_level`` (drawn with
    numpy from ``seed``, so every device gets the same): the inputs, the
    scalars and the tensors it updates in place, for nodes ``n_nodes - 1``
    .. ``2 n_nodes - 2`` of a tree of ``2 n_nodes - 1``.

    Gains are exponential with mean 4 against ι = 8, ξ = 2 (some nodes
    commit, some do not); ``ties``: integers 0..3 and no penalties;
    ``planted``: node j's maximum at (2j, 3), (2j, 9) and (2j + 1, 3) of
    unused features; ``nan``: a NaN at a valid candidate of every even
    node and at an invalid one of every odd node; ``at_cost``: negative
    gains but node j's maximum, on a paid-for feature and threshold, equal
    to its CEGB cost as the card rounds it (a product with the reciprocal
    of ``n_rows``: odd j) or one float32 step above it (even j), so that the
    last bit of the cost decides whether the node splits."""
    import torch

    rng = np.random.default_rng(seed)
    shape = (n_nodes, d, E)
    if ties:
        gain = rng.integers(0, 4, shape).astype(np.float32)
        pen = (0.0, 0.0)
    else:
        gain = (-1.0 if at_cost else 1.0) * rng.exponential(4.0, shape).astype(np.float32)
    valid = rng.random(shape) < 0.9
    totC = rng.integers(1, n_rows + 1, n_nodes).astype(np.float32)
    used_feat, used_thr = rng.random(d) < used, rng.random((d, E)) < used
    if at_cost:
        cost = np.float32(cegb) * totC * (np.float32(1) / np.float32(n_rows))
        for j in range(n_nodes):
            f, e = j % d, (3 * j) % E
            gain[j, f, e] = cost[j] if j % 2 else np.nextafter(cost[j], np.float32(np.inf))
            valid[j, f, e] = used_feat[f] = used_thr[f, e] = True
    for j in no_valid:
        valid[j] = False
    if planted:
        for j in range(n_nodes):
            for f, e in ((2 * j, 3), (2 * j, 9), (2 * j + 1, 3)):
                gain[j, f % d, e % E] = 1000.0 + j
                valid[j, f % d, e % E] = True
    if nan:
        for j in range(n_nodes):
            f, e = rng.integers(0, d), rng.integers(0, E)
            gain[j, f, e] = np.nan
            valid[j, f, e] = j % 2 == 0
    I = 2 * n_nodes - 1
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    scalar = lambda v, dtype: torch.tensor(v, dtype=dtype, device=dev)
    ins = (on(gain), on(valid), on(totC), on(rng.random(n_nodes) < dead), scalar(pen[0], torch.float32),
           scalar(pen[1], torch.float32))
    scalars = dict(cegb=cegb, n_rows=n_rows, base_idx=n_nodes - 1)
    outs = dict(
        used_feat=on(used_feat), used_thr=on(used_thr),
        t_feat=on(rng.integers(0, d, I).astype(np.int32)),
        t_thr=on(rng.integers(0, E, I).astype(np.int32)),
        t_split=on(rng.random(I) < 0.3), t_gain=on(rng.normal(size=I).astype(np.float32)),
        n_splits=scalar(7, torch.int32),
    )
    return ins, scalars, outs


def bits_equal(a, b) -> bool:
    """Equal to the bit (a float compared by its bits, so NaN = NaN)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def run_commit(fn, ins, scalars, outs) -> dict:
    """``fn`` (the kernel's wrapper or the plain version) on copies of
    ``outs``; returns the copies."""
    got = {k: v.clone() for k, v in outs.items()}
    fn(*ins, **scalars, **got)
    return got


def check_commit_kernel(dev, smi: str) -> dict:
    """The commit kernel against its plain version on the card, to the bit
    in every output, on every case of ``COMMIT_CASES``; then its time at
    each level's shape of the full-width fit (256 features x 255 edges,
    1..128 nodes) beside its bound and, at levels 0 and 7, the plain loop's
    time on the card.  Returns the level-7 numbers and a tree's time."""
    import torch

    from repro_torch.kernels.commit import commit_level, commit_level_ref

    commit_level.launches = 0
    for name, case in COMMIT_CASES.items():
        ins, scalars, outs = commit_inputs(dev, **case)
        want = run_commit(commit_level_ref, ins, scalars, outs)
        got = run_commit(commit_level, ins, scalars, outs)
        torch.cuda.synchronize()
        bad = [k for k in outs if not bits_equal(got[k], want[k])]
        if bad:
            raise SystemExit(f"[commit] {name}: the kernel differs from the plain version "
                             f"in {bad}")
        commits = int(want["n_splits"]) - int(outs["n_splits"])
        print(f"[commit] {name} ({case['n_nodes']} node(s), d={case['d']}, E={case['E']}): "
              f"the kernel equals the plain version to the bit in every output; "
              f"{commits} commit(s)")
    if commit_level.launches != len(COMMIT_CASES):
        raise SystemExit(f"[commit] {commit_level.launches} launches for "
                         f"{len(COMMIT_CASES)} calls")
    d, E = 256, 255
    tree_ms, rows = 0.0, {}
    for level in range(8):
        n_nodes = 2 ** level
        ins, scalars, outs = commit_inputs(dev, n_nodes, d, E, seed=7 + level)
        kernel = lambda: commit_level(*ins, **scalars, **outs)
        runs = [("kernel", _time_ms(kernel, 20, queued=True)),
                ("kernel", _time_ms(kernel, 20, queued=True))]
        if level in (0, 7):
            plain_outs = {k: v.clone() for k, v in outs.items()}
            plain = lambda: commit_level_ref(*ins, **scalars, **plain_outs)
            runs = [("plain", _time_ms(plain, 2))] + runs + [("plain", _time_ms(plain, 2))]
        ms = float(np.mean([t for k, t in runs if k == "kernel"]))
        plain_ms = float(np.mean([t for k, t in runs if k == "plain"])) if level in (0, 7) \
            else None
        # gain and valid once, totC and dead, the used sets in and out
        n_bytes = n_nodes * d * E * 5 + n_nodes * 5 + 2 * (d + d * E)
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        tree_ms += ms
        rows[level] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        print(f"[time] commit level {level} ({n_nodes} node(s), d={d}, E={E}): "
              + ", ".join(f"{k} {t:.4f} ms" for k, t in runs)
              + f"; kernel {ms * 1e3 / n_nodes:.2f} us a node, bound {bound_ms:.4f} ms "
              f"(bytes: {n_bytes} B at 3.35 TB/s); kernel/bound {ms / bound_ms:.1f}x"
              + (f"; plain loop {plain_ms:.3f} ms" if plain_ms is not None else ""))
    bound_tree = sum(r["bound_ms"] for r in rows.values())
    print(f"[time] commit: a depth-8 tree's 8 levels {tree_ms:.4f} ms of kernel time against "
          f"a bound of {bound_tree:.4f} ms; launches in the phase {commit_level.launches}; "
          f"card: {smi}")
    return dict(ms=rows[7]["ms"], plain_ms=rows[7]["plain_ms"], bound_ms=rows[7]["bound_ms"],
                bound_by="bytes", tree_ms=tree_ms, library_ms=None)


def train_full_width(dev, smi: str):
    """The main path of training: ``ToadModel.fit`` at the full width of
    ``toad_gbdt`` on 2^22 rows, then compress and predict on the card.
    Returns the phase's numbers, the rows and their edges (on the card)."""
    import time

    import torch

    from repro_torch.api import ToadModel
    from repro_torch.configs import get_gbdt_config
    from repro_torch.kernels.commit import commit_level
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.predict import packed_predict

    wl = get_gbdt_config("toad_gbdt")
    t0 = time.perf_counter()
    X, y = draw_rows(3, N_TRAIN, wl.n_features)
    print(f"[train] drew {N_TRAIN} x {wl.n_features} rows in "
          f"{time.perf_counter() - t0:.2f} s")
    model = ToadModel(config=wl.gbdt, n_bins=wl.n_bins, device=dev)
    histogram.launches = 0
    commit_level.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(X, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = histogram.launches
    commits = commit_level.launches
    cfg = wl.gbdt
    grown = cfg.n_rounds * cfg.n_ensembles
    n_trees = int(model.forest.n_trees)
    n_splits = int(model.forest.is_split[:n_trees].sum())
    accepted = model.history["accepted"].tolist()
    toad_bytes = float(model.aux["toad_bytes"])
    if launches < (cfg.max_depth + 1) * grown:
        raise SystemExit(f"[train] the histogram kernel ran {launches} times for "
                         f"{grown} trees of depth {cfg.max_depth}")
    if commits != cfg.max_depth * grown:
        raise SystemExit(f"[train] the commit kernel ran {commits} times for "
                         f"{grown} trees of depth {cfg.max_depth} (one a level)")
    if n_trees < 1 or n_splits < 1:
        raise SystemExit(f"[train] trained {n_trees} trees with {n_splits} splits")
    acc = model.score(X, y)
    print(f"[train] fit {N_TRAIN} x {wl.n_features}, {wl.n_bins} bins, depth "
          f"{cfg.max_depth}, {cfg.n_rounds} rounds (binning included): {fit_s:.3f} s; "
          f"histogram launches {launches}, commit launches {commits}; trees {n_trees}, "
          f"splits {n_splits}, "
          f"rounds accepted {accepted}; toad_bytes {toad_bytes}; train accuracy {acc:.4f}")
    if not acc > 0.75:
        raise SystemExit(f"[train] train accuracy {acc:.4f} is no better than chance")

    # the rounds alone, on the same bins: binning out of the window
    from repro_torch.gbdt import apply_bins, train
    from repro_torch.gbdt.trainer import _bin_storage

    edges = model.forest.edges
    # as the trainer stores them (uint8), kept for the baselines and the
    # data-parallel phases
    bins = _bin_storage(apply_bins(torch.from_numpy(X).to(dev), edges), wl.n_bins)
    yt = torch.from_numpy(y).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forest, _, aux = train(cfg, bins, yt, edges)
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
    fit = dict(cfg=cfg, bins=bins, y=yt, edges=edges, forest=forest, aux=aux,
               rounds_s=rounds_s)
    return dict(launches=launches, commit_launches=commits, fit_s=fit_s, rounds_s=rounds_s,
                n_trees=n_trees,
                n_splits=n_splits, toad_bytes=toad_bytes, accuracy=acc, **breakdown), X, fit


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
    from repro_torch.kernels.histogram import HISTOGRAM_KERNELS

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
    hist = sum(dev_ms(e) for e in on_card if any(k in e.key for k in HISTOGRAM_KERNELS))
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
          f"{hist:.1f} ms; {n_ops} device operations; no waits for the card; host "
          f"{platform.node()}, load average {os.getloadavg()[0]:.2f}")
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


# ---- slice 8: the paper's baselines and data-parallel training (B2, B1) -------

N_ACC = 1 << 20  # training rows each baseline's accuracy is read on
N_HELD_OUT = 1 << 16  # held-out rows of the RF's margin&diversity ordering
CEGB_TRADEOFF = 8.0
CCP_ALPHAS = (0.5, 2.0, 8.0)
RF_TREES = 32
DP_RANKS = 4
DP_GAP = 1e-6  # largest relative gap of a near tie a data-parallel split may flip on
# the 8-bit fit's band: the deterministic fit (exact int8 sums, one MAX
# scale) read accuracy 0.8687 and 270 splits in three runs on the H100
DP_Q8_ACCURACY = (0.85, 0.89)
DP_Q8_SPLITS = (240, 300)


def _require_launches(tag: str, launches: int, want: int) -> None:
    if launches < want:
        raise SystemExit(f"{tag}: the histogram kernel ran {launches} times, "
                         f"fewer than {want}")


def _accuracy(scores, y, threshold: float = 0.0) -> float:
    """Binary accuracy of (n, 1) scores against 0/1 labels."""
    return float(((scores[:, 0] > threshold) == (y > 0.5)).float().mean())


def baselines_phase(dev, smi: str, fit: dict, X: np.ndarray) -> None:
    """The paper's baselines (``gbdt.baselines``) at the widths of
    ``toad_gbdt``, on the training phase's 2^22 rows, bins and ToaD fit (the
    single-process forest and its aux): CEGB (8 rounds through B2; its trees
    on the card equal the CPU's at ``card_equals_cpu``'s size), CCP pruning
    of the ToaD fit at three alphas (the alpha = 2 forest served through
    ``ToadModel`` and B1 within 1e-5 of ``predict_binned``), the quantized
    and shared-table layouts of the ToaD fit (accuracy within 0.02 of it,
    the JAX tests' contract), and a 32-tree random forest through B2 with
    margin&diversity ordering on held-out rows.  Accuracies are read on the
    first 2^20 training rows."""
    import time

    import torch

    from repro_torch.api import ToadModel
    from repro_torch.core import compression_summary
    from repro_torch.gbdt import apply_bins, predict_binned, predict_raw, train
    from repro_torch.gbdt.baselines import (
        RFConfig,
        ccp_prune,
        cegb_config,
        margin_diversity_order,
        quantize_forest,
        rf_bits,
        rf_predict,
        shared_table_forest,
        take_trees,
        train_rf,
    )
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.predict import packed_predict

    cfg, bins, yt, edges, forest, aux = (fit[k] for k in
                                         ("cfg", "bins", "y", "edges", "forest", "aux"))
    D, trees = cfg.max_depth, cfg.n_rounds * cfg.n_ensembles
    rows_b, rows_y = bins[:N_ACC], yt[:N_ACC]
    toad = compression_summary(forest)
    toad_acc = _accuracy(predict_binned(forest, rows_b), rows_y)
    sizes = lambda s: (f"toad {s['toad_bytes']:.1f} B, pointer f32 {s['pointer_f32_bytes']:.0f} B, "
                       f"pointer f16 {s['pointer_f16_bytes']:.0f} B, array f32 "
                       f"{s['array_f32_bytes']:.0f} B")
    print(f"[baselines] the ToaD fit ({trees} trees): {toad['n_split_nodes']} splits, "
          f"{sizes(toad)}; accuracy {toad_acc:.4f} on the first {N_ACC} training rows")

    # ---- CEGB: coupled feature cost + per-split cost, through B2 ----------
    ccfg = cegb_config(cfg, tradeoff=CEGB_TRADEOFF)
    histogram.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_cegb, _, _ = train(ccfg, bins, yt, edges)
    torch.cuda.synchronize()
    cegb_s = time.perf_counter() - t0
    _require_launches("[baselines] CEGB", histogram.launches, (D + 1) * trees)
    cegb = compression_summary(f_cegb)
    cegb_acc = _accuracy(predict_binned(f_cegb, rows_b), rows_y)
    print(f"[baselines] CEGB (tradeoff {CEGB_TRADEOFF}: iota {ccfg.toad_penalty_feature}, "
          f"xi 0, split cost {ccfg.cegb_penalty_split} x n_node/n), {cfg.n_rounds} rounds on "
          f"{bins.shape[0]} rows: {cegb_s:.3f} s, histogram launches {histogram.launches}; "
          f"{cegb['n_split_nodes']} splits (ToaD {toad['n_split_nodes']}), {sizes(cegb)}; "
          f"accuracy {cegb_acc:.4f} (ToaD {toad_acc:.4f})")
    cegb_card_equals_cpu(dev)

    # ---- CCP: weakest-link pruning of the ToaD fit ------------------------
    pruned = {}
    for alpha in CCP_ALPHAS:
        t0 = time.perf_counter()
        pruned[alpha] = ccp_prune(forest, aux["node_gain"], aux["leaf_cnt"], alpha)
        prune_s = time.perf_counter() - t0
        s = compression_summary(pruned[alpha])
        acc = _accuracy(predict_binned(pruned[alpha], rows_b), rows_y)
        print(f"[baselines] CCP alpha={alpha}: {s['n_split_nodes']} splits (from "
              f"{toad['n_split_nodes']}), {int(pruned[alpha].n_leaf_values)} leaf-table "
              f"entries, {sizes(s)}; accuracy {acc:.4f}; pruned on the host in {prune_s:.3f} s")
    most, served = CCP_ALPHAS[-1], CCP_ALPHAS[1]
    if not compression_summary(pruned[most])["n_split_nodes"] < toad["n_split_nodes"]:
        raise SystemExit(f"[baselines] CCP at alpha={most} pruned no split")
    model = ToadModel.from_forest(pruned[served], cfg, n_bins=edges.shape[1] + 1, device=dev)
    packed_predict.launches = 0
    got = model.predict(X[:N_HIST_CASE], backend="cuda")
    want = predict_binned(pruned[served], bins[:N_HIST_CASE]).cpu().numpy()
    err = float(np.abs(got - want).max())
    if packed_predict.launches < 1 or not err <= 1e-5:
        raise SystemExit(f"[baselines] the CCP forest served within {err:.3e} of "
                         f"predict_binned with {packed_predict.launches} B1 launches")
    print(f"[baselines] the alpha={served} forest through ToadModel (compress, backend cuda) on "
          f"{N_HIST_CASE} rows: max|Δ| {err:.2e} vs predict_binned; packed_predict "
          f"launches {packed_predict.launches}")

    # ---- quantized and shared-table layouts of the ToaD fit ---------------
    xr = torch.from_numpy(X[:N_ACC]).to(dev)
    raw_acc = _accuracy(predict_raw(forest, xr), rows_y)
    for name, f in (("quantized (fp16 thresholds and leaf values)", quantize_forest(forest)),
                    ("shared table (6-bit threshold and leaf codebooks)",
                     shared_table_forest(forest))):
        acc = _accuracy(predict_raw(f, xr), rows_y)
        if not acc > raw_acc - 0.02:
            raise SystemExit(f"[baselines] {name}: accuracy {acc:.4f} vs {raw_acc:.4f}")
        print(f"[baselines] {name}: {sizes(compression_summary(f))}; accuracy {acc:.4f} "
              f"on raw rows (unquantized {raw_acc:.4f})")
    del xr

    # ---- random forest through B2, margin&diversity ordering --------------
    rcfg = RFConfig(task="binary", n_trees=RF_TREES, max_depth=D)
    histogram.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rf, n_splits = train_rf(rcfg, bins, yt, edges)
    torch.cuda.synchronize()
    rf_s = time.perf_counter() - t0
    _require_launches("[baselines] RF", histogram.launches, RF_TREES * (D + 1))
    rf_acc = _accuracy(rf_predict(rf, rows_b), rows_y, threshold=0.5)
    chance = float(max(rows_y.mean(), 1 - rows_y.mean()))
    if not rf_acc > chance:
        raise SystemExit(f"[baselines] RF accuracy {rf_acc:.4f}, chance {chance:.4f}")
    print(f"[baselines] RF {RF_TREES} trees of depth {D} on {bins.shape[0]} rows: {rf_s:.3f} s, "
          f"histogram launches {histogram.launches}; {n_splits} splits, rf_bits "
          f"{rf_bits(n_splits, RF_TREES)} ({rf_bits(n_splits, RF_TREES) / 8:.0f} B); accuracy "
          f"{rf_acc:.4f} (chance {chance:.4f})")
    Xh, yh = draw_rows(9, N_HELD_OUT, X.shape[1])
    bh = apply_bins(torch.from_numpy(Xh).to(dev), edges)
    tree_preds = np.stack([(predict_binned(take_trees(rf, [t]), bh)[:, 0] > 0.5).cpu().numpy()
                           for t in range(RF_TREES)]).astype(np.int64)
    t0 = time.perf_counter()
    order = margin_diversity_order(tree_preds, yh.astype(np.int64))
    md_s = time.perf_counter() - t0
    yh_t = torch.from_numpy(yh).to(dev)
    all_acc = _accuracy(rf_predict(rf, bh), yh_t, threshold=0.5)
    half_acc = _accuracy(rf_predict(take_trees(rf, order[:RF_TREES // 2]), bh), yh_t,
                         threshold=0.5)
    print(f"[baselines] margin&diversity order on {N_HELD_OUT} held-out rows in {md_s:.3f} s: "
          f"{order.tolist()}; held-out accuracy {all_acc:.4f} with {RF_TREES} trees, "
          f"{half_acc:.4f} with the first {RF_TREES // 2}")


@contextlib.contextmanager
def _exact_cpu_sums():
    """The port's histograms of CPU tensors summed in float64 and rounded to
    float32 once, in place of float32 in row order: the kernel's arithmetic
    (exact fixed-point sums, converted once), as a reference for the card."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import histogram_ref

    plain = ops.histogram
    ops.histogram = lambda bins, gh, pos, n_nodes, n_bins: histogram_ref(
        bins, gh.double(), pos, n_nodes, n_bins).float()
    try:
        yield
    finally:
        ops.histogram = plain


def cegb_card_equals_cpu(dev) -> None:
    """CEGB at ``card_equals_cpu``'s size, its trees on the card against
    the CPU's.  CEGB charges nothing for a new threshold (xi = 0), so
    adjacent edges of a feature often tie to ~1e-5, and the CPU's float32
    row-order sums (which drift ~1e-4 relative) pick between them.  So the
    card's trees are held to the CPU trainer with exact sums
    (``_exact_cpu_sums``): feature, thr_bin, is_split, leaf_ref, n_trees,
    n_leaf_values equal, leaf values within 1e-5 (rtol and atol); where the
    plain CPU fit differs, its first differing node is printed with both
    sides' penalised gains."""
    import dataclasses

    import torch

    from repro_torch.api import ToadModel
    from repro_torch.configs import get_gbdt_config
    from repro_torch.gbdt.baselines import cegb_config

    cfg = cegb_config(dataclasses.replace(get_gbdt_config("toad_gbdt").gbdt, max_depth=6,
                                          n_rounds=2), tradeoff=CEGB_TRADEOFF)
    X, y = draw_rows(5, 1 << 15, 256)
    fit = lambda device: ToadModel(config=cfg, n_bins=256, device=device).fit(X, y)
    card, cpu = fit(dev), fit("cpu")
    with _exact_cpu_sums():
        exact = fit("cpu")
    for k in ("feature", "thr_bin", "is_split", "leaf_ref", "n_trees", "n_leaf_values"):
        if not torch.equal(getattr(card.forest, k).cpu(), getattr(exact.forest, k)):
            raise SystemExit(f"[baselines] CEGB: {k} differs between the card and the CPU "
                             "with exact sums")
    got, want = card.forest.leaf_values.cpu(), exact.forest.leaf_values
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise SystemExit(f"[baselines] CEGB: leaf values differ by {err:.3e}")
    diff = _first_difference(cpu.forest, card.forest, cpu.aux, card.aux, cfg)
    plain = "equal to the card's" if diff is None else (
        f"first differs at tree {diff[0]}, node {diff[1]}: (split, feature, edge) {diff[2]} "
        f"with penalised gain {diff[4]!r} on the CPU, {diff[3]} with {diff[5]!r} on the "
        f"card, relative gap {abs(diff[4] - diff[5]) / max(abs(diff[4]), abs(diff[5])):.3e}")
    print(f"[baselines] CEGB card=cpu, n=32768, d=256, depth 6, 2 rounds: the card's trees "
          f"equal the CPU's with exact sums ({int(card.forest.is_split.sum())} splits; leaf "
          f"values max|Δ| {err:.3e}); the CPU's float32 row-order fit {plain}")

def _first_difference(a, b, aux_a, aux_b, cfg):
    """The first node, in commit order (tree by tree, node index within a
    tree), whose split differs between forests ``a`` and ``b``, with each
    side's penalised gain there (its recorded gain less the ι and ξ it paid
    given the splits before; 0 for a side that did not split); ``None``
    when every split is equal."""
    from repro_torch.gbdt import forest_to_numpy

    A, B = forest_to_numpy(a), forest_to_numpy(b)
    gains = [aux["node_gain"].cpu().numpy() for aux in (aux_a, aux_b)]
    used_f, used_t = set(), set()

    def split(F, t, i):
        on = bool(F["is_split"][t, i])
        return (on, int(F["feature"][t, i]) if on else -1, int(F["thr_bin"][t, i]) if on else -1)

    def penalised(k, g, t, i):
        if not k[0]:
            return 0.0
        return (float(g[t, i]) - cfg.toad_penalty_feature * (k[1] not in used_f)
                - cfg.toad_penalty_threshold * ((k[1], k[2]) not in used_t))

    for t in range(max(int(A["n_trees"]), int(B["n_trees"]))):
        for i in range(A["is_split"].shape[1]):
            ka, kb = split(A, t, i), split(B, t, i)
            if ka != kb:
                return t, i, ka, kb, penalised(ka, gains[0], t, i), penalised(kb, gains[1], t, i)
            if ka[0]:
                used_f.add(ka[1])
                used_t.add(ka[1:])
    return None


def dp_rank(rank, device, shard_dir: str, cfg):
    """One rank of ``data_parallel_phase``'s second world: round 0's
    level-0 histogram (B2 on the rank's rows, with the trainer's base
    statistics and gradients), reduced by the trainer's exact all-reduce
    and by ``quantized_psum`` at 16 and 8 bits, then the fits with
    quantized collectives at 16 and 8 bits (timed inside the rank)."""
    import dataclasses
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import all_reduce_sum, quantized_psum
    from repro_torch.gbdt import forest_to_numpy, make_loss
    from repro_torch.gbdt.distributed import load_shard, train_data_parallel
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.ops import build_histogram

    world = dist.get_world_size()
    bins, y, edges = load_shard(shard_dir, rank, world, device)
    loss = make_loss(cfg.task, cfg.n_classes)
    s, cnt = loss.base_stats(y)
    stats = all_reduce_sum(torch.cat([s, cnt.reshape(1)]))
    base = loss.base_from_stats(stats[:-1], stats[-1]).to(torch.float32)
    g, h = loss.grad_hess(y, base[None, :].expand(y.shape[0], -1).clone())
    gh = torch.stack([g[:, 0], h[:, 0], torch.ones_like(y)], -1)
    pos = torch.zeros(y.shape, dtype=torch.int32, device=device)
    local = build_histogram(bins, gh, pos, n_nodes=1, n_bins=edges.shape[1] + 1)
    # the same histogram through the quantized collectives, with the shared
    # maximum that sets their quantum
    amax = local.abs().max().reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    quantized = {bits: quantized_psum(local, bits=bits).cpu().numpy() for bits in (16, 8)}
    level0 = all_reduce_sum(local)
    out = dict(level0=level0.cpu().numpy(), quantized=quantized,
               quanta={bits: float(amax) * world / (2 ** (bits - 1) - 1) for bits in (16, 8)})
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for bits in (16, 8):
        histogram.launches = 0
        sync()
        t0 = time.perf_counter()
        forest, _, _ = train_data_parallel(dataclasses.replace(cfg, hist_quant_bits=bits),
                                           bins, y, edges)
        sync()
        out[bits] = dict(forest=forest_to_numpy(forest) if rank == 0 else None,
                         launches=histogram.launches, seconds=time.perf_counter() - t0)
    return out


def data_parallel_phase(dev, smi: str, fit: dict, tmp: str) -> None:
    """Data-parallel training on 4 ranks sharing the one card (gloo, which
    reduces CUDA tensors through host memory), on the training phase's 2^22
    x 256 bins: first through ``spawn_data_parallel`` (the rows handed over
    as memory-mapped ``.npy`` files, 2^20 contiguous rows a rank), exact
    collectives, 8 rounds, every rank's histograms through B2; then a second
    world (``run_ranks``) for round 0's level-0 reduced histogram and the
    fits with quantized collectives at 16 and 8 bits.

    Gates: the exact data-parallel forest equals the single-process card
    forest on the same bins (feature, thr_bin, is_split, leaf_ref equal;
    leaf values within 2e-5).  Each rank's B2 sums are exact (int64 fixed
    point), but the all-reduce adds four float32 results, so a split whose
    gain ties another's to ~1e-7 may flip: then the first differing node is
    printed with both sides' penalised gains, and the phase passes only if
    their relative gap is at most 1e-6 (``DP_GAP``).  The level-0 reduced
    histogram within 1e-5 (rtol and atol) of the single-process one, counts
    equal, and through the quantized collectives within 4 quanta.  The
    16-bit fit's accuracy at least the exact data-parallel fit's - 0.02
    (the contract of ``tests/test_distributed.py``), on the first 2^20
    training rows.  The 8-bit fit has no such contract (JAX's loses too:
    one scale, set by the count channel, leaves the g and h sums few
    levels); it is deterministic (exact integer sums, one MAX scale), so
    its accuracy and split count are held to bands around its readings
    (``DP_Q8_ACCURACY``, ``DP_Q8_SPLITS``), with room on both sides: a
    change that moves them out, better or worse, changes the 8-bit path
    and must update the bands with its readings."""
    import time

    import torch

    from repro_torch.gbdt import forest_from_numpy, make_loss, predict_binned
    from repro_torch.gbdt.distributed import run_ranks, save_shards, spawn_data_parallel
    from repro_torch.kernels.ops import build_histogram

    cfg, bins, yt, edges, forest, aux = (fit[k] for k in
                                         ("cfg", "bins", "y", "edges", "forest", "aux"))
    n, d = bins.shape
    B, D = edges.shape[1] + 1, cfg.max_depth
    trees = cfg.n_rounds * cfg.n_ensembles
    t0 = time.perf_counter()
    f_dp, h_dp, aux_dp = spawn_data_parallel(cfg, bins, yt, edges, world_size=DP_RANKS,
                                             device=dev)
    dp_s = time.perf_counter() - t0
    launches = aux_dp["rank_histogram_launches"]
    _require_launches("[data-parallel] a rank of the exact fit", min(launches), (D + 1) * trees)
    preds_err = float((aux_dp["preds"] - aux["preds"]).abs().max())
    diff = _first_difference(f_dp, forest, aux_dp, aux, cfg)
    if diff is None:
        for k in ("feature", "thr_bin", "is_split", "leaf_ref", "n_trees", "n_leaf_values"):
            if not torch.equal(getattr(f_dp, k), getattr(forest, k)):
                raise SystemExit(f"[data-parallel] {k} differs from the single-process fit")
        leaf_err = float((f_dp.leaf_values - forest.leaf_values).abs().max())
        if not leaf_err <= 2e-5:
            raise SystemExit(f"[data-parallel] leaf values differ by {leaf_err:.3e}")
        print(f"[data-parallel] spawn_data_parallel, {DP_RANKS} ranks on {dev} (gloo), "
              f"{n // DP_RANKS} rows a rank, exact collectives, {cfg.n_rounds} rounds: "
              f"feature, thr_bin, is_split, leaf_ref, n_trees, n_leaf_values equal to the "
              f"single-process card fit; leaf values max|Δ| {leaf_err:.3e}; preds (every "
              f"rank's rows in row order) max|Δ| {preds_err:.3e}")
    else:
        t, i, ka, kb, ga, gb = diff
        gap = abs(ga - gb) / max(abs(ga), abs(gb), 1e-30)
        print(f"[data-parallel] the first differing split: tree {t}, node {i}: data-parallel "
              f"(split, feature, edge) {ka}, penalised gain {ga!r}; single-process {kb}, "
              f"{gb!r}; relative gap {gap:.3e} (a near tie passes at <= {DP_GAP})")
        if gap > DP_GAP:
            raise SystemExit("[data-parallel] the trees differ by more than a near tie")
    print(f"[data-parallel] the exact fit: {dp_s:.3f} s in all (spawn, CUDA start, shards "
          f"written and loaded, training), of which training "
          f"{max(aux_dp['rank_train_seconds']):.3f} s (slowest rank); the single-process "
          f"rounds on the same bins {fit['rounds_s']:.3f} s; histogram launches a rank "
          f"{launches} (>= {(D + 1) * trees}: {D + 1} a tree)")

    save_shards(tmp, bins, yt, edges)
    t0 = time.perf_counter()
    ranks = run_ranks(dp_rank, DP_RANKS, tmp, cfg, device=dev)
    world_s = time.perf_counter() - t0
    loss = make_loss(cfg.task, cfg.n_classes)
    base = loss.base_from_stats(*loss.base_stats(yt)).to(torch.float32)
    g, h = loss.grad_hess(yt, base[None, :].expand(n, -1).clone())
    gh = torch.stack([g[:, 0], h[:, 0], torch.ones_like(yt)], -1)
    want = build_histogram(bins, gh, torch.zeros((n,), dtype=torch.int32, device=dev),
                           n_nodes=1, n_bins=B)
    got = torch.from_numpy(ranks[0]["level0"]).to(dev)
    err = float((got - want).abs().max())
    if not (torch.allclose(got, want, rtol=1e-5, atol=1e-5)
            and torch.equal(got[..., 2], want[..., 2])):
        raise SystemExit(f"[data-parallel] round 0's level-0 histogram differs by {err:.3e}")
    print(f"[data-parallel] round 0, level 0: the {DP_RANKS} ranks' B2 histograms "
          f"all-reduced vs B2 on all {n} rows: max|Δ| {err:.3e} (allclose at rtol = atol "
          f"= 1e-5), counts equal")

    rows_b, rows_y = bins[:N_ACC], yt[:N_ACC]
    exact_acc = _accuracy(predict_binned(f_dp, rows_b), rows_y)
    chance = float(max(rows_y.mean(), 1 - rows_y.mean()))
    for bits in (16, 8):
        # every rank's rounding is at most one quantum (half a quantum, or
        # the clip to floor(qmax / n)), so the sum is within n quanta
        quantum = ranks[0]["quanta"][bits]
        q_err = max(float(np.abs(r["quantized"][bits] - r["level0"]).max()) for r in ranks)
        bound = DP_RANKS * quantum * (1 + 1e-6) + 4 * float(np.spacing(np.float32(
            np.abs(ranks[0]["level0"]).max())))
        if not q_err <= bound:
            raise SystemExit(f"[data-parallel] round 0's level-0 histogram through the "
                             f"{bits}-bit collective: max|Δ| {q_err:.4g} > {bound:.4g}")
        f_q = forest_from_numpy(ranks[0][bits]["forest"], cfg.n_ensembles, device=dev)
        acc = _accuracy(predict_binned(f_q, rows_b), rows_y)
        splits = int(f_q.is_split.sum())
        q_launches = [r[bits]["launches"] for r in ranks]
        _require_launches(f"[data-parallel] a rank at {bits} bits", min(q_launches),
                          (D + 1) * trees)
        # 16 bits: the JAX package's quality contract; 8 bits: the bands
        # of its readings (docstring)
        if bits == 16 and not acc >= exact_acc - 0.02:
            raise SystemExit(f"[data-parallel] 16-bit collectives: accuracy {acc:.4f} "
                             f"vs {exact_acc:.4f} exact")
        if bits == 8 and not (DP_Q8_ACCURACY[0] <= acc <= DP_Q8_ACCURACY[1]
                              and DP_Q8_SPLITS[0] <= splits <= DP_Q8_SPLITS[1]):
            raise SystemExit(f"[data-parallel] 8-bit collectives: accuracy {acc:.4f} "
                             f"(band {DP_Q8_ACCURACY}), {splits} splits (band {DP_Q8_SPLITS})")
        print(f"[data-parallel] round 0, level 0 through quantized_psum({bits} bits): max|Δ| "
              f"{q_err:.4g} vs the exact all-reduce, within {DP_RANKS} quanta (a quantum: "
              f"{quantum:.4g})")
        same = all(torch.equal(getattr(f_q, k), getattr(f_dp, k))
                   for k in ("feature", "thr_bin", "is_split"))
        gate = (f"accuracy >= {exact_acc - 0.02:.4f}" if bits == 16 else
                f"accuracy in {DP_Q8_ACCURACY}, splits in {DP_Q8_SPLITS}")
        print(f"[data-parallel] hist_quant_bits={bits} (sibling subtraction off): accuracy "
              f"{acc:.4f} (exact {exact_acc:.4f}, chance {chance:.4f}; gate {gate}); "
              f"splits {splits} (exact "
              f"{int(f_dp.is_split.sum())}), trees {'equal to' if same else 'differ from'} "
              f"the exact fit's; training {max(r[bits]['seconds'] for r in ranks):.3f} s "
              f"(slowest rank); histogram launches a rank {q_launches}")
    print(f"[data-parallel] the second world (level 0, both quantized fits): "
          f"{world_s:.3f} s in all")

    node = d * B * 3  # elements of one node's histogram
    exact_nodes, quant_nodes = 2 ** (D - 1), 2 ** D - 1
    leaves = 2 ** D * 3
    print(f"[data-parallel] collectives a tree (from the code): exact {D + 1} all-reduces "
          f"(one a level, one for the leaves), quantized {2 * (D + 1)} (a MAX and a sum "
          f"each); two a fit for the base statistics and the row count.  Payload a rank a tree: exact "
          f"{exact_nodes} nodes x {node * 4} B + leaves {leaves * 4} B = "
          f"{exact_nodes * node * 4 + leaves * 4} B; quantized, no subtraction, {quant_nodes} "
          f"nodes: {quant_nodes * node * 4 + leaves * 4} B in the int32 carrier of 16 bits, "
          f"{quant_nodes * node + leaves} B at int8; card: {smi}")


#: the nine histogram calls of one full-width tree: (label, nodes, bins);
#: level 0 builds the root, level L >= 1 the left children of 2^(L-1)
#: parents, the leaf call one bin of 256 nodes
TREE_CALLS = ([("level 0", 1, 256)] + [(f"level {L}", 2 ** (L - 1), 256) for L in range(1, 8)]
              + [("leaves", 256, 1)])


def time_histogram(dev, smi: str, label: str, n_nodes: int, B: int, dropped: bool) -> dict:
    """The kernel at one call's shape of the full-width fit (2^22 rows, 256
    uint8 features row-major; the leaf call one feature of one bin), beside
    the bound, the plain version and one ``index_add_`` call; then its
    output held, as in ``check_histogram_kernel``, to the plain version in
    float64 on the same inputs (within 1e-5, counts equal, two runs equal to
    the bit).  A level >= 1 call passes each row's child: left rows under
    their parent, right rows either with their channels zeroed
    (``dropped=False``, the form the timings before the kernel's redesign
    were taken in) or with pos = -1 (``dropped=True``, the trainer's call),
    whose bound counts only the kept rows' bins and channels."""
    import torch

    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.ref import histogram_ref

    leaf = B == 1
    n, d = N_TRAIN, 1 if leaf else 256
    gen = torch.Generator(device=dev).manual_seed(n_nodes + B)
    bins = (torch.zeros((n, 1), dtype=torch.uint8, device=dev) if leaf else
            torch.randint(0, B, (n, d), device=dev, generator=gen).to(torch.uint8))
    gh = torch.stack([0.5 * torch.randn(n, device=dev, generator=gen),
                      0.25 * torch.rand(n, device=dev, generator=gen),
                      torch.ones(n, device=dev)], -1)
    sibling = label != "level 0" and not leaf
    child = torch.randint(0, 2 * n_nodes if sibling else n_nodes, (n,), device=dev,
                          generator=gen)
    pos = torch.div(child, 2, rounding_mode="floor") if sibling else child
    if sibling and dropped:
        pos = torch.where(child % 2 == 0, pos, -1)
    elif sibling:
        gh = torch.where((child % 2 == 0)[:, None], gh, 0.0)
    pos = pos.to(torch.int32)
    del child
    n_bytes, n_ops = histogram_work(bins, gh, pos, n_nodes, B, kept_only=dropped)
    kernel = lambda: histogram(bins, gh, pos, n_nodes=n_nodes, n_bins=B)
    plain = lambda: histogram_ref(bins, gh, pos, n_nodes, B)
    runs = [("plain", _time_ms(plain, 2)), ("kernel", _time_ms(kernel, 5)),
            ("kernel", _time_ms(kernel, 5)), ("plain", _time_ms(plain, 2))]
    ms = float(np.mean([t for k, t in runs if k == "kernel"]))
    plain_ms = float(np.mean([t for k, t in runs if k == "plain"]))
    # the library call: index_add_ over prebuilt (node, feature, bin) ids of
    # the kept rows
    kept = (pos >= 0) & (pos < n_nodes)
    rows = kept.sum().item()
    ids = (pos[kept].long()[:, None] * (d * B) + torch.arange(d, device=dev)[None, :] * B
           + bins[kept].long()).reshape(-1)
    data = gh[kept][:, None, :].expand(rows, d, 3).reshape(-1, 3)
    out = torch.zeros((n_nodes * d * B, 3), device=dev)
    library_ms = _time_ms(lambda: out.index_add_(0, ids, data), 3)
    del ids, data, out, kept
    torch.cuda.empty_cache()
    call = ("right rows dropped (pos -1)" if dropped else
            "right rows' channels zeroed" if sibling else "all rows in range")
    # the plain version in float64 takes ~45 GB at 2^22 x 256
    got, again, fp32 = kernel(), kernel(), plain()
    want = histogram_ref(bins, gh.double(), pos, n_nodes, B)
    torch.cuda.synchronize()
    err = _compare(f"{label}, n={n}, d={d}, {n_nodes} node(s), {B} bin(s), {call}",
                   got, want, again, fp32)
    del got, again, fp32, want, bins, gh, pos
    torch.cuda.empty_cache()
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[time] histogram {label} ({n_nodes} node(s), n={n}, d={d}, {B} uint8 bin(s); "
          f"{call}): " + ", ".join(f"{k} {t:.4f} ms" for k, t in runs))
    print(f"[time] histogram {label}, {call}: kernel {ms:.4f} ms/call, plain version "
          f"{plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; {n_bytes} B at 3.35 TB/s = {bytes_ms:.4f} ms; {n_ops} fp32 adds "
          f"at 67 TFLOP/s = {ops_ms:.4f} ms); kernel/bound {ms / bound_ms:.1f}x; card: {smi}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


def time_tree_histograms(dev, smi: str, launches: int) -> tuple[dict, float]:
    """``time_histogram`` at the nine calls of a tree, the levels >= 1 in
    both forms; then the time a fit's histogram calls take at those shapes
    (each shape ``launches / 9`` times a fit) in the trainer's form.
    Returns the level-0 numbers (for the kernels line) and the largest
    |kernel - plain (float64)| over all the calls."""
    rows = []
    for label, n_nodes, B in TREE_CALLS:
        forms = (False, True) if label not in ("level 0", "leaves") else (False,)
        for dropped in forms:
            rows.append((label, dropped, time_histogram(dev, smi, label, n_nodes, B, dropped)))
    per_shape = launches / len(TREE_CALLS)
    trainer = [t for label, dropped, t in rows
               if dropped or label in ("level 0", "leaves")]
    fit_ms = per_shape * sum(t["ms"] for t in trainer)
    bound_ms = per_shape * sum(t["bound_ms"] for t in trainer)
    print("[time] histogram, the trainer's calls (ms: kernel / bound / plain / index_add_): "
          + "; ".join(f"{label}{' dropped' if dropped else ''} {t['ms']:.4f} / "
                      f"{t['bound_ms']:.4f} / {t['plain_ms']:.1f} / {t['library_ms']:.1f}"
                      for label, dropped, t in rows))
    print(f"[time] histogram: {per_shape:g} launches a shape a fit ({launches} in all): "
          f"{fit_ms:.1f} ms of kernel time a fit at these shapes, against a bound of "
          f"{bound_ms:.1f} ms; card: {smi}")
    level0 = {k: v for k, v in rows[0][2].items() if k != "max_abs_err"}
    return level0, max(t["max_abs_err"] for _, _, t in rows)


# ---- early-exit serving (kernel B3) -------------------------------------------

def check_predict_kernel(dev, on_card, full, x_full: np.ndarray) -> float:
    """B1 against its plain version on the card, equal to the bit, over cases
    that take every variant of its launch plan: the full-width model ``full``
    at ``N_FULL`` rows (``x_full``) and the serve buckets, its trees over
    16,384 leaf values, C = 3, depth 10, every feature used, a zero-split
    and a zero-tree model.  ``on_card``
    makes ``(forest, DevicePacked)`` from forest arrays.  Returns the
    largest |kernel - plain| (0.0 when equal)."""
    import torch

    from repro_torch.core.pipeline import probe_inputs
    from repro_torch.kernels.predict import packed_predict
    from repro_torch.kernels.ref import packed_predict_ref

    _, wide = on_card(synthetic_forest(0, n_leaf_values=16_384))
    mc_forest, mc = on_card(synthetic_forest(
        1, n_trees=21, max_depth=4, n_ensembles=3, n_used_features=24), 3)
    zs_forest, zs = on_card(synthetic_forest(2, n_trees=32, n_used_features=0))
    zt_forest, zt = on_card(synthetic_forest(3, n_trees=0))
    # full width, C = 3: tree_block 9, so tree blocks 1, 2, ... start off a
    # 16-byte boundary in the words
    c3_forest, c3 = on_card(synthetic_forest(5, n_trees=27, n_ensembles=3), 3)
    x_c3 = probe_inputs(c3_forest, n=65_536, seed=6)
    d10_forest, d10 = on_card(synthetic_forest(6, n_trees=24, max_depth=10))  # words global
    fu_forest, fu = on_card(synthetic_forest(7, n_used_features=256))  # x global
    cases = [
        (f"full width d=256 depth 8 T=256, n={N_FULL}, 1% NaN", full, x_full),
        ("multiclass C=3 T=21 depth 4", mc, probe_inputs(mc_forest, n=1000, seed=3)),
        ("zero-split |F_U|=0", zs, probe_inputs(zs_forest, n=1000, seed=4)),
        ("zero-tree T=0", zt, probe_inputs(zt_forest, n=1000, seed=5)),
        (f"full width, 16,384 leaf values, n={N_FULL}, 1% NaN", wide, x_full),
        ("full width C=3 T=27, n=65536", c3, x_c3),
        ("full width C=3 T=27, n=256", c3, x_c3[:256]),
        ("full width depth 10 T=24 (tree blocks read from global memory), n=16384", d10,
         probe_inputs(d10_forest, n=16_384, seed=7)),
        (f"full width, all {fu.used_features.numel()} features used (x read from global "
         "memory), n=65536", fu, probe_inputs(fu_forest, n=65_536, seed=8)),
    ] + [(f"full width n={n}", full, x_full[:n]) for n in (1, 255, 256, 257, 4096, 16_384)]
    check_variants_driven("kernel", [plan_of(p, x.shape[0]) for _, p, x in cases
                                     if p.words.shape[0]], early_exit=False)
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
        # the plain version's block order: equal to the bit
        if not torch.equal(got, want):
            raise SystemExit(f"[kernel] {label}: differs from the plain version "
                             f"(max|Δ| {err:.3e})")
        how = plan_of(p, x.shape[0]).describe() if p.words.shape[0] else "no launch"
        print(f"[kernel] {label}: {how}; equal to the plain version to the bit")
    return max_abs_err


N_EE_TRAIN = 1 << 20  # rows of the 64-round fit: binning and fit stay near 30 s
EE_ROUNDS = 64  # the configuration's 8 rounds would leave one tree block to exit at


def check_early_exit_kernel(dev) -> float:
    """The early-exit kernel against its plain version on the card: scores,
    trees evaluated and exits equal to the bit, and two runs equal; labels
    equal to B1's full evaluation, and rows that did not exit equal to it to
    the bit.  The cases take every variant of the kernel's launch plan.
    Returns the largest |kernel - plain| over the scores (0.0 when equal)."""
    import torch

    from repro_torch.core.layout import decode, encode, to_packed
    from repro_torch.core.pipeline import probe_inputs
    from repro_torch.core.treeorder import remaining_mass
    from repro_torch.gbdt.forest import forest_from_numpy
    from repro_torch.kernels.ops import to_device
    from repro_torch.kernels.predict import (
        device_exit_tables,
        packed_predict,
        packed_predict_early_exit,
    )

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
    cases += [(f"T=24, n={m}", f24, p24, x24[:m], 0.0, 0) for m in (1, 255, 257, 4096)]
    f10, p10 = model(early_exit_forest(24, n_trees=24, max_depth=10))
    cases.append(("T=24, depth 10: tree blocks read from global memory", f10, p10,
                  rows(f10, 16_384, 26, nan=0.01), 0.0, 0))
    fu, pu = model(early_exit_forest(25, n_trees=24, n_used_features=256))
    cases.append((f"T=24, all {pu.used_features.numel()} features used: x read from global "
                  "memory", fu, pu, rows(fu, n, 27, nan=0.01), 0.0, 0))
    fs, ps = model(synthetic_forest(26, n_trees=64, n_leaf_values=1024))
    cases.append(("T=64 over 1,024 shared leaf values", fs, ps, rows(fs, n, 28, nan=0.01),
                  0.0, 0))
    check_variants_driven("ee-kernel", [plan_of(p, x.shape[0], True)
                                        for _, _, p, x, _, _ in cases], early_exit=True)

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
        full = packed_predict(x, *p.arrays(), **p.meta())
        label_of = (lambda s: s[:, 0] > 0) if C == 1 else (lambda s: s.argmax(1))
        if not torch.equal(label_of(got[0]), label_of(full)):
            raise SystemExit(f"[ee-kernel] {label}: labels differ from B1's full evaluation")
        if not torch.equal(got[0][~exited], full[~exited]):
            raise SystemExit(f"[ee-kernel] {label}: rows that did not exit differ from B1")
        print(f"[ee-kernel] {label}: {plan_of(p, x.shape[0], True).describe()}; scores, "
              "trees and exits equal to the plain version to the bit, two runs (host bound, "
              "tables made once) equal; labels equal to B1's, rows that did not exit equal "
              f"to B1 to the bit; mean trees {float(trees.float().mean()):.3f} of {T}, "
              f"{float(exited.float().mean()):.1%} exited")
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
          f"B1 {ne_err:.3e} (both sum in the block order: equal to the bit)")
    if mism or not on_blocks or not torch.equal(scores[ne], full[ne]):
        raise SystemExit("[ee] the full-width early-exit run broke its contract")
    del xt
    path = model.save(f"{tmp}/ee.toad")
    times = time_early_exit(dev, smi, dp, tables, policy, Xh)
    return dict(path=path, model=model, Xh=Xh, n_trees=T, fit_s=fit_s,
                mean_trees=mean_trees, share=share, **times)


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
        runs = [("plain", _time_ms(plain, plain_reps)),
                ("kernel", _time_ms(ee, reps, queued=True)),
                ("B1", _time_ms(b1, reps, queued=True)),
                ("kernel", _time_ms(ee, reps, queued=True)),
                ("B1", _time_ms(b1, reps, queued=True)),
                ("plain", _time_ms(plain, plain_reps))]
        host_ms = _host_ms(ee, reps)
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
        print(f"[time] B3 n={n}, T={dp.words.shape[0]}, depth {dp.max_depth}, "
              f"{dp.used_features.numel()} used features, {dp.leaf_values.numel()} leaf "
              f"values (B3: {plan_of(dp, n, True).describe()}; B1: "
              f"{plan_of(dp, n).describe()}): "
              + ", ".join(f"{k} {t:.4f} ms" for k, t in runs)
              + f"; the wrapper's host time per call {host_ms:.4f} ms")
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

# ---- binning (kernel B4) ------------------------------------------------------


def binning_inputs(n: int, d: int, E: int, seed: int):
    """(n, d) rows and (d, E) sorted edge rows drawn from ``seed`` with the
    cases the binning kernel must take: +inf-padded tails (the last fifth
    of every row from E >= 5), a feature whose edges are all +inf (feature
    3 when d > 3), rows exactly on an edge and one ulp either side, NaN and
    ±inf inputs."""
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.standard_normal((d, E)), axis=1).astype(np.float32)
    if E >= 5:
        edges[:, E - E // 5:] = np.inf
    if d > 3:
        edges[3] = np.inf
    x = rng.standard_normal((n, d)).astype(np.float32)
    if E:
        r, f = rng.integers(0, n, 3 * n // 4 + 1), rng.integers(0, d, 3 * n // 4 + 1)
        on = edges[f, rng.integers(0, max(E - E // 5, 1), f.shape[0])]
        fin = np.isfinite(on)
        step = rng.integers(-1, 2, f.shape[0]).astype(np.float32)  # -1, 0, +1 ulp
        x[r[fin], f[fin]] = np.where(step[fin] == 0, on[fin], np.nextafter(
            on[fin], np.where(step[fin] > 0, np.inf, -np.inf).astype(np.float32)))
    u = rng.random(x.shape)
    x[u < 0.03] = np.nan
    x[(u >= 0.03) & (u < 0.04)] = np.inf
    x[(u >= 0.04) & (u < 0.05)] = -np.inf
    return x, edges


#: (n, d, E) of the binning kernel's cases: scalar loads (d = 1, 9, 6,
#: 258) and 4-feature vector loads (d = 4, 256, 36), E on both sides of a
#: power of two, several row tiles (n = 4,097); E = 4,096 takes the
#: global-memory edge rows (above the staging cap), with scalar and vector
#: loads
BINNING_CASES = ([(n, d, E) for n in (1, 511, 512, 513, 700) for d in (1, 9)
                  for E in (1, 40, 255)] + [(700, 9, 4096), (513, 256, 512)]
                 + [(700, d, E) for d in (4, 6, 256, 258) for E in (1, 127, 128, 255, 256)]
                 + [(513, 256, 4096), (4097, 36, 255)])


def check_binning_kernel(dev) -> float:
    """The binning kernel against its plain version on the card: equal
    element by element, two runs equal, on every case of ``BINNING_CASES``
    (the staged and the global-memory variant); E = 0 returns zeros without
    a launch.  Returns the largest |kernel - plain| (0 when equal)."""
    import torch

    from repro_torch.kernels.binning import binning, launch_plan
    from repro_torch.kernels.ref import binning_ref

    max_err = 0
    for i, (n, d, E) in enumerate(BINNING_CASES):
        x, edges = binning_inputs(n, d, E, seed=100 + i)
        xt, et = torch.from_numpy(x).to(dev), torch.from_numpy(edges).to(dev)
        before = binning.launches
        got, again = binning(xt, et), binning(xt, et)
        want = binning_ref(xt, et)
        torch.cuda.synchronize()
        if binning.launches != before + 2:
            raise SystemExit(f"[bin-kernel] n={n} d={d} E={E}: the kernel did not launch")
        if got.shape != (n, d) or got.dtype != torch.int32:
            raise SystemExit(f"[bin-kernel] n={n} d={d} E={E}: bad output {tuple(got.shape)}")
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want) or not torch.equal(got, again):
            raise SystemExit(f"[bin-kernel] n={n} d={d} E={E}: differs from the plain "
                             "version or between two runs")
        plan = launch_plan(n, d, E, xt.data_ptr() % 16 == 0)
        print(f"[bin-kernel] n={n}, d={d}, E={E} ({'staged' if plan.staged else 'global'} "
              f"edges, {plan.vec}-feature loads; NaN, ±inf, on-edge ±1 ulp, +inf tails): "
              "equal to the plain version element by element, two runs equal")
    # contiguous but not 16-byte aligned: x one row into a larger tensor (d
    # odd), and one element into a flat one (d = 8): scalar loads
    for d, flat in ((9, False), (8, True)):
        x, edges = binning_inputs(701, d, 255, seed=7 + d)
        big, et = torch.from_numpy(x).to(dev), torch.from_numpy(edges).to(dev)
        xt = big.view(-1)[1:1 + 700 * d].view(700, d) if flat else big[1:]
        if not xt.is_contiguous() or xt.data_ptr() % 16 == 0 or launch_plan(
                700, d, 255, False).vec != 1:
            raise SystemExit(f"[bin-kernel] the misaligned d={d} case is not misaligned")
        if not torch.equal(binning(xt, et), binning_ref(xt, et)):
            raise SystemExit(f"[bin-kernel] misaligned x, d={d}: differs from the plain version")
        print(f"[bin-kernel] n=700, d={d}, E=255, x {'4' if flat else str(4 * d)} bytes off "
              "16-byte alignment (scalar loads): equal to the plain version")
    x, _ = binning_inputs(100, 4, 0, seed=99)
    before = binning.launches
    out = binning(torch.from_numpy(x).to(dev), torch.zeros((4, 0), device=dev))
    if binning.launches != before or out.any() or out.shape != (100, 4):
        raise SystemExit("[bin-kernel] E=0 launched or gave non-zero bins")
    print("[bin-kernel] E=0: zeros, no launch")
    return float(max_err)


def binning_full_width(dev, smi: str, X: np.ndarray, edges) -> dict:
    """B4's path at full width: the training phase's 2^22 x 256 rows and
    their ``fit_bins`` edges (255 a feature) through ``ops.apply_binning``,
    equal to the trainer's ``apply_bins`` element by element; then the
    kernel, its plain version and ``torch.searchsorted`` timed, in turns,
    beside the bytes bound."""
    import math

    import torch

    from repro_torch.gbdt import apply_bins
    from repro_torch.kernels.binning import binning
    from repro_torch.kernels.ops import apply_binning
    from repro_torch.kernels.ref import binning_ref

    torch.cuda.empty_cache()
    n, d = X.shape
    E = edges.shape[1]
    # fit_bins' edges are column-major; apply_binning hands the kernel this copy
    edges = edges.contiguous()
    print(f"[bin] cut: rows 2^24 -> 2^{int(math.log2(n))} ({n}), as in the training phase")
    xt = torch.from_numpy(X).to(dev)
    torch.cuda.synchronize()
    binning.launches = 0
    got = apply_binning(xt, edges, device=dev)
    torch.cuda.synchronize()
    launches = binning.launches
    if launches != 1:
        raise SystemExit(f"[bin] apply_binning launched the kernel {launches} times")
    if not torch.equal(got, apply_bins(xt, edges)):
        raise SystemExit("[bin] apply_binning differs from the trainer's apply_bins")
    if not torch.equal(got, binning_ref(xt, edges)):
        raise SystemExit("[bin] the kernel differs from its plain version at full width")
    del got
    torch.cuda.empty_cache()
    print(f"[bin] n={n}, d={d}, E={E}: ops.apply_binning (one launch) equals the "
          "trainer's apply_bins and the plain version element by element")
    kernel = lambda: binning(xt, edges)
    plain = lambda: binning_ref(xt, edges)
    runs = [("plain", _time_ms(plain, 1)), ("kernel", _time_ms(kernel, 10)),
            ("kernel", _time_ms(kernel, 10)), ("plain", _time_ms(plain, 1))]
    ms = float(np.mean([t for k, t in runs if k == "kernel"]))
    plain_ms = float(np.mean([t for k, t in runs if k == "plain"]))
    # the library call, as apply_bins makes it: edges against the rows
    # transposed (the copy made outside the timing), an int64 result
    x_t = xt.t().contiguous()
    library_ms = _time_ms(lambda: torch.searchsorted(edges, x_t, side="left"), 3)
    del x_t
    n_bytes = n * d * (4 + 4) + d * E * 4
    n_ops = n * d * math.ceil(math.log2(E + 1))  # fp32 compares of the search
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[time] binning n={n}, d={d}, E={E}: " + ", ".join(f"{k} {t:.4f} ms" for k, t in runs))
    print(f"[time] binning: kernel {ms:.4f} ms/call, plain version {plain_ms:.3f} ms, "
          f"torch.searchsorted {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{n_bytes} B at 3.35 TB/s = {bytes_ms:.4f} ms; {n_ops} fp32 compares at 67 "
          f"TFLOP/s = {ops_ms:.4f} ms); kernel/bound {ms / bound_ms:.2f}x; card: {smi}")
    del xt
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---- compression and artifact writing ------------------------------------------


def rejecting_budget(trace):
    """``(budget, max_pred_delta, rejected)`` from a ladder trace (``(name,
    n_bytes, drift)`` per rung, in ladder order) under which a rung that
    fits is rejected on accuracy and a later one accepted: the budget is
    the rejected rung's own size (no earlier rung fits it), the floor
    halfway between its drift and the largest smaller drift of a later rung
    that also fits.  ``None`` when the trace has no such pair."""
    for i, (name, nb, delta) in enumerate(trace):
        if any(e[1] <= nb for e in trace[:i]):
            continue
        later = [e[2] for e in trace[i + 1:] if e[1] <= nb and e[2] < delta]
        if later:
            return nb, (delta + max(later)) / 2, name
    return None


def compress_full_width(dev, smi: str, model, tmp: str) -> None:
    """Slice 3 at full width on the early-exit phase's 64-round model:
    ``compress(budget_bytes=B)`` with B half the exact stream, the same
    compression of a CPU copy (the identical stream), a second call whose
    ``max_pred_delta`` rejects a rung that fits, ``save`` (toadcheck),
    ``load_checked``, the serve CLI on the bundle through ``packed_predict``
    (parity 0 against the reference backend of the lossy forest), and a
    copy with one stream byte flipped refused (TOAD106) by ``load_checked``
    and by the serve CLI."""
    import time

    import torch

    from repro_torch.api import ArtifactError, ToadModel, load_checked
    from repro_torch.core.codebook import quantize
    from repro_torch.core.layout import encode
    from repro_torch.core.pipeline import (
        _predict,
        default_ladder,
        probe_inputs,
        run_pipeline,
    )
    from repro_torch.kernels.predict import packed_predict
    from repro_torch.launch import serve

    exact = model.encoded.n_bytes
    budget = float(exact // 2)
    forest = model.forest_exact
    probe = probe_inputs(forest)

    def secs(fn, reps=3):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        return ", ".join(f"{t:.4f}" for t in out)

    leaves = forest.leaf_values[: int(forest.n_leaf_values)].cpu()
    print(f"[compress] pieces of a rung, s per call (3 calls each): encode of the exact "
          f"{int(forest.n_trees)}-tree forest {secs(lambda: encode(forest))}; quantize of "
          f"its {leaves.numel()}-entry leaf table at 6 bits "
          f"{secs(lambda: quantize(leaves, bits=6))}; predict_raw of the "
          f"{probe.shape[0]}-row probe on the card {secs(lambda: _predict(forest, probe))}")
    t0 = time.perf_counter()
    trace = []
    for spec in default_ladder():
        rep = run_pipeline(forest, spec, probe=probe).report
        trace.append((spec.name, rep.n_bytes, rep.max_abs_pred_delta))
    print(f"[compress] the ladder on the {int(forest.n_trees)}-tree full-width model "
          f"({time.perf_counter() - t0:.2f} s): " + "; ".join(
              f"{nm} {nb:.1f} B, max|Δpred| {dl:.4g}" for nm, nb, dl in trace))
    t0 = time.perf_counter()
    model.compress(budget_bytes=budget)
    card_s = time.perf_counter() - t0
    rep = model.compression_report
    first = next(nm for nm, nb, _ in trace if nb <= budget)
    if not rep.fits or rep.spec.name != first or len(rep.ladder) < 2:
        raise SystemExit(f"[compress] budget {budget:.0f} B chose {rep.spec.name!r} "
                         f"after {len(rep.ladder)} rung(s); the trace's first fit is {first!r}")
    print(f"[compress] compress(budget_bytes={budget:.0f}) (half the exact {exact:.1f} B) "
          f"in {card_s:.2f} s: rung {rep.spec.name!r}, {rep.n_bytes:.1f} B, ratio "
          f"{rep.ratio:.3f}x, max|Δpred| {rep.max_abs_pred_delta:.4g}\n{rep.summary()}")
    cpu = ToadModel.from_forest(forest, model.config, n_bins=model.n_bins, device="cpu")
    cpu.compress(budget_bytes=budget)
    same = (cpu.encoded.n_bits == model.encoded.n_bits
            and np.array_equal(cpu.encoded.data, model.encoded.data))
    if not same or cpu.spec != model.spec:
        raise SystemExit("[compress] the CPU copy compressed to another stream")
    print(f"[compress] the same compress on a CPU copy of the forest: rung "
          f"{cpu.spec.name!r}, the identical {cpu.encoded.n_bits}-bit stream; "
          f"max|Δpred| on the CPU {cpu.compression_report.max_abs_pred_delta:.4g}")

    path = model.save(f"{tmp}/lossy.toad")  # toadcheck runs before the write
    loaded = load_checked(path, device=dev)
    if not np.array_equal(loaded.model.encoded.data, model.encoded.data):
        raise SystemExit("[compress] the loaded bundle holds another stream")
    print(f"[compress] saved {path} (toadcheck before the write), load_checked: format "
          f"v{loaded.format_version}, {len(loaded.diagnostics)} finding(s)")
    packed_predict.launches = 0
    served = serve.main(["--arch", "toad-gbdt", "--model", path, "--backend", "cuda",
                         "--requests", "2048", "--clients", "4"])
    launches = packed_predict.launches
    warm = 9  # the engine warms one shape bucket a power of two up to 256 rows
    # B1 sums in the Pallas kernel's 8-tree block order, the dense reference
    # tree by tree: scores within 1e-5 of it, the gate every serve phase holds
    if not served["max_abs_err"] <= 1e-5 or launches != served["n_batches"] + warm:
        raise SystemExit(f"[compress] served parity {served['max_abs_err']:.3e}, "
                         f"{launches} launches for {served['n_batches']} batches")
    print(f"[compress] serve CLI on the lossy bundle, --backend cuda: "
          f"{served['n_requests']} requests, {served['req_per_s']:.1f} req/s, parity "
          f"{served['max_abs_err']:.2e} vs the reference backend of the lossy forest; "
          f"packed_predict launches {launches} = {served['n_batches']} batches + {warm} "
          "warm-up buckets")

    bad = f"{tmp}/flipped.toad"
    with np.load(path) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    arrays["toad_stream"][len(arrays["toad_stream"]) // 2] ^= 0x5A
    with open(bad, "wb") as f:
        np.savez_compressed(f, **arrays)
    try:
        load_checked(bad, device=dev)
        raise SystemExit("[compress] load_checked admitted a corrupted bundle")
    except ArtifactError as e:
        if "TOAD106" not in str(e):
            raise SystemExit(f"[compress] the corrupted bundle was refused without TOAD106: {e}")
    try:
        serve.main(["--arch", "toad-gbdt", "--model", bad, "--backend", "cuda", "--smoke"])
        raise SystemExit("[compress] the serve CLI served a corrupted bundle")
    except SystemExit as e:
        if not e.code or "TOAD106" not in str(e.code):
            raise
    print("[compress] a copy with one stream byte flipped: refused by load_checked "
          "(TOAD106) and by the serve CLI (non-zero exit)")

    pick = rejecting_budget(trace)
    if pick is None:
        raise SystemExit("[compress] no rung that fits has a later fitting rung with a "
                         "smaller drift: the floor cannot be shown rejecting a rung")
    budget2, floor, rejected = pick
    model.compress(budget_bytes=budget2, max_pred_delta=floor)
    rep2 = model.compression_report
    rung = next(r for r in rep2.ladder if r["spec"] == rejected)
    if not rung["fits"] or rung["accuracy_ok"] or rep2.spec.name == rejected:
        raise SystemExit(f"[compress] the floor did not reject {rejected!r}")
    print(f"[compress] compress(budget_bytes={budget2:.2f}, max_pred_delta={floor:.4g}): "
          f"{rejected!r} fits and is rejected on accuracy; rung {rep2.spec.name!r}, "
          f"{rep2.n_bytes:.1f} B, max|Δpred| {rep2.max_abs_pred_delta:.4g}\n"
          f"{rep2.summary()}")



# ---- slice 5: the serve path's host split, and serving resilience ------------

N_SERVE = 2048  # requests of each serving run: the serve CLI's default


def _drive(engine, rows, clients: int = 4) -> list:
    """Submit ``rows`` through ``engine`` from ``clients`` threads, as the
    serve CLI's clients do; returns every future, in row order."""
    import concurrent.futures

    futs = [None] * len(rows)

    def client(lo, hi):
        for i in range(lo, hi):
            futs[i] = engine.submit(rows[i])

    bounds = [(c * len(rows) // clients, (c + 1) * len(rows) // clients)
              for c in range(clients)]
    with concurrent.futures.ThreadPoolExecutor(clients) as pool:
        for job in [pool.submit(client, lo, hi) for lo, hi in bounds]:
            job.result()
    return futs


def serve_host_split(dev, smi: str, model, rows: np.ndarray) -> dict:
    """Where the worker's host time goes, batch by batch, at the serve CLI's
    engine settings (the ``cuda`` backend, 256-row buckets, 2 ms wait, 4
    client threads, 2,048 requests a run).

    The engine's spans, read with ``tracing.collect()``, give its four
    steps a batch (dequeue and wait, ``np.stack`` and padding, the predict
    through the chain, resolving the futures).  Its predict function is
    what a ``GBDTEngine`` on ``cuda`` calls, with the copies made outside
    the model's predictor so that each is timed on the host clock:
    ``as_rows`` to the card, the predictor (the wrapper and the launch),
    the scores back to the host (which waits for the kernel).  No
    synchronisation is added.  CUDA events around the predictor's call,
    read after the copy back, give the call's span on the card's clock:
    the kernels' time when the card sets the pace, the host's launches
    when the host does.

    Four runs at the interpreter's switch interval, then four at 0.5 ms,
    after a first run that pays the worker thread's first copies: if the
    copies' stalls are waits for the GIL while the client threads run,
    the shorter interval cuts them."""
    import sys
    import time

    import torch

    from repro_torch import tracing
    from repro_torch.api import MicroBatchEngine
    from repro_torch.api.engine import WORKER_STEPS
    from repro_torch.kernels.ops import as_rows
    from repro_torch.kernels.predict import packed_predict

    clock = time.perf_counter
    predictor = model.predictor("cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    inner: list[tuple] = []  # (h2d, call, d2h) host s and the call's span on the card

    def predict(rows_np):
        t0 = clock()
        x = as_rows(rows_np, dev)
        t1 = clock()
        start.record()
        out = predictor(x)
        end.record()
        t2 = clock()
        scores = out.cpu().numpy()
        t3 = clock()
        inner.append((t1 - t0, t2 - t1, t3 - t2, start.elapsed_time(end) / 1e3))
        return scores

    engine = MicroBatchEngine(predict, int(model.forest.n_features), max_batch=256,
                              max_wait_ms=2.0, backend_name="cuda", device=dev)
    ref = model.predict(rows[:N_SERVE], backend="reference")
    default_interval = sys.getswitchinterval()
    out = {}

    def batch_steps(spans) -> list[dict]:
        """Host seconds of each served batch's steps, keyed by WORKER_STEPS,
        once the worker has closed the last batch's spans."""
        deadline = clock() + 10.0
        while any(s.end_ns == 0 for s in spans) and clock() < deadline:
            time.sleep(1e-4)
        steps = {s.index: {} for s in spans if s.name == "engine.batch"}
        for s in spans:
            if s.parent in steps and s.name.startswith("engine."):
                steps[s.parent][s.name[len("engine."):]] = s.duration_ns * 1e-9
        return [st for st in steps.values() if tuple(st) == WORKER_STEPS]

    def one_run():
        inner.clear()
        packed_predict.launches = 0
        with tracing.collect() as spans:
            t0 = clock()
            futs = _drive(engine, rows[:N_SERVE])
            got = np.stack([f.result(timeout=60) for f in futs])
            wall = clock() - t0
        steps = batch_steps(spans)
        err = float(np.abs(got - ref).max())
        if err > 1e-5 or packed_predict.launches != len(steps) or len(inner) != len(steps):
            raise SystemExit(f"[serve] host split: parity {err:.2e}, "
                             f"{packed_predict.launches} launches for {len(steps)} batches")
        split = []
        for st, (h2d, call, d2h, kern) in zip(steps, inner):
            split.append({"dequeue": st["dequeue"], "stack": st["stack"], "h2d": h2d,
                          "call": call, "d2h": d2h,
                          "chain": st["predict"] - h2d - call - d2h,
                          "resolve": st["resolve"], "call (events)": kern})
        return split, wall, err

    with engine:
        try:
            split, wall, _ = one_run()  # the worker thread's first copies
            print(f"[serve] host split, first run: {len(split)} batches in "
                  f"{wall * 1e3:.1f} ms; worker ms a batch "
                  + ", ".join(f"{k} {np.mean([b[k] for b in split]) * 1e3:.4f}"
                              for k in split[0]))
            for label, interval in (("default", default_interval), ("0.5 ms", 5e-4)):
                sys.setswitchinterval(interval)
                batches, walls = [], []
                for _ in range(4):
                    split, wall, err = one_run()
                    batches += split
                    walls.append(wall * 1e3)
                keys = list(batches[0])
                ms = {k: np.array([b[k] for b in batches]) * 1e3 for k in keys}
                host_keys = [k for k in keys if k != "call (events)"]
                total = float(sum(ms[k].mean() for k in host_keys))
                print(f"[serve] host split, switch interval {label} ({interval * 1e3:g} ms): "
                      f"{len(batches)} batches in 4 runs of {N_SERVE} requests, wall "
                      + " ".join(f"{w:.1f}" for w in walls)
                      + " ms; worker ms a batch (mean / median / p90 / max): "
                      + ", ".join(f"{k} {v.mean():.4f} / {np.median(v):.4f} / "
                                  f"{np.percentile(v, 90):.4f} / {v.max():.4f}"
                                  for k, v in ms.items())
                      + f"; sum of host means {total:.4f} ms "
                      f"({total * len(batches) / sum(walls):.1%} of the runs' wall, whose first dequeue "
                      f"began before the run); last parity "
                      f"{err:.2e}; card: {smi}")
                out[label] = dict(interval_s=interval, n_batches=len(batches),
                                  wall_ms=walls,
                                  mean_ms={k: float(v.mean()) for k, v in ms.items()},
                                  median_ms={k: float(np.median(v)) for k, v in ms.items()},
                                  max_ms={k: float(v.max()) for k, v in ms.items()})
        finally:
            sys.setswitchinterval(default_interval)
    s = engine.stats()
    if s.n_requests != 9 * N_SERVE:
        raise SystemExit(f"[serve] host split: {s.n_requests} of {9 * N_SERVE} served")
    # the same copy with no client thread running: what a batch's rows take
    # to reach the card when nothing competes with the worker
    alone = []
    batch = np.ascontiguousarray(rows[:256])
    for _ in range(201):
        t0 = clock()
        as_rows(batch, dev)
        torch.cuda.synchronize()
        alone.append((clock() - t0) * 1e3)
    alone = alone[1:]
    print(f"[serve] host split: all runs p50 {s.latency_p50_ms:.2f} ms, p95 "
          f"{s.latency_p95_ms:.2f} ms, mean batch {s.mean_batch:.1f}; the h2d step alone "
          f"(256 rows, no other thread, 200 calls): mean {np.mean(alone):.4f} / median "
          f"{np.median(alone):.4f} / max {np.max(alone):.4f} ms; steps of the engine: "
          f"{', '.join(WORKER_STEPS)}")
    out["h2d_alone_ms"] = float(np.mean(alone))
    return out


def resilience_phase(dev, model, path: str, rows: np.ndarray) -> None:
    """Slice 5 on the card, on the serve phase's full-width model: the serve
    CLI under a policy (no fault: the kernel serves every batch), a
    ``GBDTEngine`` whose ``cuda`` backend is faulted until its breaker opens
    and then recovers, and a worker crash the supervisor restarts."""
    import time
    from pathlib import Path

    from repro_torch.api import GBDTEngine, ResiliencePolicy, WorkerCrashed
    from repro_torch.fleet import Fault, FaultPlan, FutureLedger
    from repro_torch.kernels.predict import packed_predict
    from repro_torch.launch import serve

    # ---- 1. the serve CLI under a policy with the chain, nothing faulted --
    # the chain comes only from a --resilience spec; the CLI itself exits
    # non-zero if a fallback served a batch
    spec = Path(path).with_name("policy.json")
    spec.write_text(ResiliencePolicy(fallback=True).to_json())
    packed_predict.launches = 0
    served = serve.main(["--arch", "toad-gbdt", "--model", path, "--backend", "cuda",
                         "--resilience", str(spec), "--deadline-ms", "1000",
                         "--max-queue", "4096", "--requests", str(N_SERVE),
                         "--clients", "4"])
    launches = packed_predict.launches
    resolved = served["n_requests"] + served["n_shed"] + served["n_deadline_expired"]
    print(f"[resilience] serve CLI --backend cuda --resilience {{fallback: true}} "
          f"--deadline-ms 1000 --max-queue 4096: "
          f"{served['n_requests']} served + {served['n_shed']} shed + "
          f"{served['n_deadline_expired']} expired of {N_SERVE}; parity "
          f"{served['max_abs_err']:.2e}; fallback batches {served['n_fallback_batches']}; "
          f"active {served['active_backend']}; breakers {served['breaker_state']}; "
          f"packed_predict launches {launches} for {served['n_batches']} batches")
    if (resolved != N_SERVE or served["max_abs_err"] > 1e-5
            or served["n_fallback_batches"] != 0 or served["active_backend"] != "cuda"
            or launches < served["n_batches"] or served["policy"] is None
            or list(served["breaker_state"]) != ["cuda", "packed", "reference"]):
        raise SystemExit("[resilience] the unfaulted policy run broke its contract")

    ledger = FutureLedger()
    ref = model.predict(rows[:256], backend="reference")

    def batch(engine, lo, hi):
        futs = [ledger.track(engine.submit(r)) for r in rows[lo:hi]]
        return np.stack([f.result(timeout=30) for f in futs])

    def state(engine, tag):
        s = engine.stats()
        print(f"[resilience] {tag}: batches {s.n_batches}, fallback batches "
              f"{s.n_fallback_batches}, retries {s.n_predict_retries}, restarts "
              f"{s.n_worker_restarts}, active {s.active_backend}, breakers "
              f"{s.breaker_state}, packed_predict launches {packed_predict.launches}")
        return s

    # ---- 2. the kernel's backend faulted until its breaker opens ---------
    # the cooldown outlasts the fallback batches (the plain traversal of 256
    # trees takes ~0.1 s a batch on the card); the probe waits for it
    threshold, cooldown_ms = 3, 3000.0
    plan = FaultPlan([Fault(point="predict", backend="cuda", count=threshold,
                            message="injected kernel fault")])
    policy = ResiliencePolicy(fallback=True, max_retries=0, breaker_threshold=threshold,
                              breaker_cooldown_ms=cooldown_ms)
    engine = GBDTEngine(model, backend="cuda", policy=policy, faults=plan)
    if [n for n, _ in engine._chain] != ["cuda", "packed", "reference"]:
        raise SystemExit(f"[resilience] chain {[n for n, _ in engine._chain]}")
    with engine:
        packed_predict.launches = 0
        errs = []
        t_open = time.perf_counter()
        for k in range(threshold + 1):  # three faulted, one inside the cooldown
            errs.append(float(np.abs(batch(engine, 32 * k, 32 * k + 32)
                                     - ref[32 * k:32 * k + 32]).max()))
        fallback_s = time.perf_counter() - t_open
        opened = state(engine, f"after {threshold} injected cuda faults and one batch "
                               f"in the cooldown ({fallback_s:.2f} s)")
        during = packed_predict.launches
        give_up = time.perf_counter() + 3 * cooldown_ms / 1e3
        while (engine.stats().breaker_state["cuda"] == "open"
               and time.perf_counter() < give_up):
            time.sleep(0.05)
        half = engine.stats().breaker_state["cuda"]
        errs.append(float(np.abs(batch(engine, 128, 160) - ref[128:160]).max()))
        recovered = state(engine, f"after the cooldown ({half} probe)")
        after = packed_predict.launches
    print(f"[resilience] faulted batches served by packed on the card within "
          f"{max(errs):.2e} of reference; injected {plan.n_fired('predict')} faults; "
          f"breaker open -> {half} -> {recovered.breaker_state['cuda']}; "
          f"packed_predict launches {during} while open, {after} after the recovery")
    if (opened.breaker_state["cuda"] != "open"
            or not opened.n_fallback_batches == opened.n_batches >= threshold + 1
            or opened.active_backend != "packed" or half != "half_open"
            or recovered.breaker_state["cuda"] != "closed"
            or recovered.active_backend != "cuda" or after <= during
            or max(errs) > 1e-5 or plan.n_fired("predict") != threshold):
        raise SystemExit("[resilience] the breaker did not fall back and return to cuda")

    # ---- 3. a worker crash with a batch in hand ---------------------------
    plan = FaultPlan([Fault(point="worker", at=(1,), count=1, message="injected crash")])
    engine = GBDTEngine(model, backend="cuda", faults=plan,
                        policy=ResiliencePolicy(restart_budget=2, fallback=False))
    with engine:
        batch(engine, 0, 32)
        crashed = [ledger.track(engine.submit(r)) for r in rows[32:64]]
        outcomes = [type(f.exception(timeout=30)).__name__ for f in crashed]
        packed_predict.launches = 0
        err = float(np.abs(batch(engine, 64, 96) - ref[64:96]).max())
        s = state(engine, "after an injected worker crash")
    n_crashed = outcomes.count(WorkerCrashed.__name__)
    print(f"[resilience] worker crash: {n_crashed} in-flight futures failed with "
          f"WorkerCrashed, {s.n_worker_restarts} restart, then served on "
          f"{s.active_backend} within {err:.2e}")
    if (n_crashed < 1 or set(outcomes) - {WorkerCrashed.__name__, "NoneType"}
            or s.n_worker_restarts != 1 or s.active_backend != "cuda"
            or packed_predict.launches < 1 or err > 1e-5):
        raise SystemExit("[resilience] the supervisor did not restart the worker")

    # ---- 4. no future of steps 2-3 stranded -------------------------------
    ledger.assert_all_resolved(timeout=10.0)
    print(f"[resilience] FutureLedger: all {len(ledger)} futures resolved "
          f"{ledger.outcomes(timeout=0)}")


# ---- slice 6: the .toadpack container and progressive scoring ----------------


def stream_phase(dev, smi: str, model, forest_arrays: dict, config, x_rows: np.ndarray,
                 tmp: str) -> dict:
    """Slice 6 on the card, on the serve phase's 256-tree full-width model:
    ``save_streaming`` (32 tree blocks, deep-verified), the same bytes as a
    CPU copy's ``write_pack``, ``open_streaming`` on the card, a
    ``ProgressiveScorer`` (its default, ``packed``) fed block by block over
    262,144 rows and held to B1 at the end, and the TOAD111 / TOAD112
    refusals."""
    import time
    from pathlib import Path

    import torch

    from repro_torch.analysis import errors, verify_pack
    from repro_torch.api import ToadModel, save_streaming
    from repro_torch.gbdt.forest import forest_from_numpy
    from repro_torch.kernels.ops import predict_packed_model
    from repro_torch.stream import StreamingError, open_streaming, read_manifest, write_pack

    t0 = time.perf_counter()
    path = save_streaming(model, f"{tmp}/m.toadpack")
    save_s = time.perf_counter() - t0
    man = read_manifest(path)
    t0 = time.perf_counter()
    deep = verify_pack(path, deep=True)
    verify_s = time.perf_counter() - t0
    cpu = ToadModel.from_forest(forest_from_numpy(forest_arrays, 1, device="cpu"),
                                config, n_bins=256, device="cpu").compress()
    cpu_path = write_pack(cpu, f"{tmp}/cpu.toadpack")
    same = Path(path).read_bytes() == Path(cpu_path).read_bytes()
    ee_rows = len((man.get("early_exit") or {}).get("remaining_mass") or [])
    print(f"[stream] save_streaming: {man['n_trees']} trees in {man['n_blocks']} blocks of "
          f"{man['tree_block']}, {Path(path).stat().st_size} B, early-exit bound table "
          f"{ee_rows} rows, in {save_s:.2f} s; verify_pack(deep=True) {len(deep)} "
          f"finding(s) in {verify_s:.2f} s; bytes equal to a CPU copy's write_pack: {same}")
    if (man["n_blocks"] != 32 or errors(deep) or deep or not same
            or ee_rows != man["n_trees"] + 1):
        raise SystemExit("[stream] the pack is not the 32-block clean CPU-equal container")

    # ---- progressive scoring on the card, block by block ------------------
    # the scorer's default backend: ``packed``, the torch traversal on the
    # card.  A block's cost is the growth of ``predict``'s device time from
    # one block to the next (each predict re-walks every block fed)
    xt = torch.from_numpy(x_rows).to(dev)
    torch.cuda.synchronize()
    t_open = time.perf_counter()
    sm = open_streaming(path, device=dev)
    scorer = sm.scorer()
    if scorer.backend != "packed":
        raise SystemExit(f"[stream] the default scorer runs {scorer.backend!r}")
    feed_ms, predict_ms, device_ms = [], [], []
    ttfp_ms = None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    while True:
        t0 = time.perf_counter()
        if not scorer.feed_next():
            break
        feed_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        start.record()
        res = scorer.predict(xt)  # brings the sums to the host: synchronised
        end.record()
        predict_ms.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
        if ttfp_ms is None:
            ttfp_ms = (time.perf_counter() - t_open) * 1e3
    total_ms = (time.perf_counter() - t_open) * 1e3
    block_ms = np.diff([0.0] + device_ms)
    k = np.arange(1, len(device_ms) + 1)
    slope_ms = float(np.polyfit(k, device_ms, 1)[0])
    b1 = predict_packed_model(model.device_packed(), xt, device=dev)
    err = float(np.abs(res.scores - b1.cpu().numpy()).max())
    print(f"[stream] ProgressiveScorer (default backend {scorer.backend}) on {dev}, "
          f"n={xt.shape[0]} rows: first partial score {ttfp_ms:.1f} ms after open_streaming; "
          f"total {total_ms:.1f} ms for {len(feed_ms)} blocks (each predict re-walks every "
          f"block fed); per block (ms): feed (decode + copy to the card) "
          + " ".join(f"{t:.2f}" for t in feed_ms)
          + "; predict after k blocks, device (events) "
          + " ".join(f"{t:.3f}" for t in device_ms)
          + "; host clock "
          + " ".join(f"{t:.1f}" for t in predict_ms)
          + "; one block's evaluation = growth from k-1 to k blocks: "
          + " ".join(f"{t:.3f}" for t in block_ms)
          + f" (least-squares slope {slope_ms:.4f} ms a block); converged scores vs B1 "
          f"max|Δ| {err:.2e}; card: {smi}")
    if not res.score_is_final or err > 1e-5:
        raise SystemExit(f"[stream] converged scores {err:.2e} from B1")

    # ---- refusals ---------------------------------------------------------
    raw = bytearray(Path(path).read_bytes())
    raw[man["blocks"][1]["offset"]] ^= 0xFF
    Path(f"{tmp}/flipped.toadpack").write_bytes(bytes(raw))
    Path(f"{tmp}/trunc.toadpack").write_bytes(Path(path).read_bytes()[:-16])
    codes = {}
    for kind in ("flipped", "trunc"):
        bad = f"{tmp}/{kind}.toadpack"
        found = sorted({d.code for d in errors(verify_pack(bad, deep=True))})
        try:
            open_streaming(bad, device=dev).scorer(backend="packed").feed_all()
            refused = "served"
        except StreamingError as e:
            refused = "refused: " + " ".join(sorted({w[:7] for w in str(e).split()
                                                     if w.startswith("TOAD11")}))
        codes[kind] = (found, refused)
    print(f"[stream] one byte flipped in tree block 1: verify_pack {codes['flipped'][0]}, "
          f"open_streaming + feed_all {codes['flipped'][1]}; 16 bytes cut from the end: "
          f"verify_pack {codes['trunc'][0]}, open_streaming {codes['trunc'][1]}")
    if (codes["flipped"][0] != ["TOAD111"] or "TOAD111" not in codes["flipped"][1]
            or codes["trunc"][0] != ["TOAD112"] or "TOAD112" not in codes["trunc"][1]):
        raise SystemExit("[stream] a corrupted pack was not refused with its code")
    return dict(ttfp_ms=ttfp_ms, total_ms=total_ms, block_ms=slope_ms, err=err)


def stream_early_exit(dev, model, Xh: np.ndarray, tmp: str) -> None:
    """``feed_until_confident`` with ``EarlyExitPolicy(0)`` on the 64-round
    early-exit model's pack, over its 262,144 held-out rows on the card:
    the labels must be the full ensemble's (B1's)."""
    import time

    import torch

    from repro_torch.api import EarlyExitPolicy, save_streaming
    from repro_torch.kernels.ops import predict_packed_model
    from repro_torch.stream import open_streaming

    path = save_streaming(model, f"{tmp}/ee.toadpack")
    xt = torch.from_numpy(Xh).to(dev)
    scorer = open_streaming(path, device=dev).scorer(backend="packed")
    t0 = time.perf_counter()
    res = scorer.feed_until_confident(xt, EarlyExitPolicy(epsilon=0.0))
    fut_s = time.perf_counter() - t0
    full = predict_packed_model(model.device_packed(), xt, device=dev).cpu().numpy()
    mism = int(np.sum((res.scores[:, 0] > 0) != (full[:, 0] > 0)))
    print(f"[stream] feed_until_confident(EarlyExitPolicy(0)) on the {int(model.forest.n_trees)}"
          f"-tree early-exit pack, n={xt.shape[0]} held-out rows on the card: "
          f"{res.blocks_evaluated} of {res.n_blocks} blocks fed ({res.trees_evaluated} trees), "
          f"exit_reason {res.exit_reason}, {fut_s:.2f} s; label mismatches vs B1's full "
          f"evaluation {mism}")
    if mism:
        raise SystemExit(f"[stream] {mism} labels changed under feed_until_confident")


# ---- slice 7: the multi-model fleet ------------------------------------------

# forests of a fleet, each compressed along the ladder: 3 (12 .toad, 2 packs and
# 12 early-exit models), cut from 8, 6 and then 5 so the run stays inside its
# time limit as its phases grow; every admission scales with it, and 12
# classic models still overflow the LRU's 8 hot ones
N_FLEET_FORESTS = 3
FLEET_RUNGS = ("cbl4", "cbl2", "thr6", "exact")


def serving_config():
    """The toad_gbdt configuration's knobs, with one round per synthetic tree."""
    from repro_torch.gbdt.trainer import GBDTConfig

    return GBDTConfig(task="binary", n_rounds=256, max_depth=8, learning_rate=0.1,
                      toad_penalty_feature=8.0, toad_penalty_threshold=2.0,
                      leaf_capacity=8192)


def build_ladder(task) -> dict:
    """One forest of a fleet compressed along the ladder and saved, on the
    host (run in a worker process).  ``task`` is ``(kind, seed, directory,
    rungs, pack)``: kind ``syn`` draws ``synthetic_forest(seed)``, ``ee``
    ``early_exit_forest(seed)``; with ``pack`` the first rung is also
    written as a 32-block ``.toadpack``.  Returns seconds per rung."""
    import time

    import torch

    from repro_torch.api import CompressionSpec, ToadModel, save_streaming
    from repro_torch.gbdt.forest import forest_from_numpy

    torch.set_num_threads(1)  # one worker a core
    kind, seed, out, rungs, pack = task
    specs = {"cbl4": CompressionSpec.codebook_full(6, 4),
             "cbl2": CompressionSpec.codebook_full(6, 2),
             "thr6": CompressionSpec.thr_codebook(6), "exact": CompressionSpec.exact()}
    arrays = (early_exit_forest if kind == "ee" else synthetic_forest)(seed)
    model = ToadModel.from_forest(forest_from_numpy(arrays, 1, device="cpu"),
                                  serving_config(), n_bins=256, device="cpu")
    times = {}
    for rung in rungs:
        t0 = time.perf_counter()
        model.compress(spec=specs[rung]).save(f"{out}/{kind}{seed:02d}_{rung}.toad")
        if pack and rung == rungs[0]:
            save_streaming(model, f"{out}/{kind}{seed:02d}_{rung}_pack.toadpack")
        times[rung] = time.perf_counter() - t0
    return times


def _fleet_cli(*argv):
    """``python -m repro_torch.launch.fleet ARGV`` as a subprocess."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.fleet", *argv],
                          capture_output=True, text=True, env=env, timeout=900)


def _cuda_growth(dev, build):
    """``build()``'s result, the growth of ``torch.cuda.memory_allocated``
    across it, and its seconds."""
    import gc
    import time

    import torch

    gc.collect()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = build()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.memory_allocated(dev) - before, time.perf_counter() - t0


def fleet_phase(dev, smi: str, tmp: str) -> dict:
    """Slice 7 on the card: a fleet of 12 full-width artifacts
    (``N_FLEET_FORESTS`` = 3 synthetic forests along the 4-rung ladder, two
    of them also as 32-block packs) and an early-exit fleet of 12, built on
    host processes; admission and
    refusal through the fleet CLI; the pool's shared tensors and the card
    memory they save; routed traffic through the fleet CLI and the serve
    CLI (B1, with a hot swap, and streaming); the LRU and a swap's drain at
    the engine; early exit through the fleet CLI (B3); and chaos."""
    import concurrent.futures
    import multiprocessing
    import shutil
    import time

    import torch

    from repro_torch.api import ResiliencePolicy
    from repro_torch.fleet import (
        Fault,
        FaultPlan,
        FleetEngine,
        FutureLedger,
        InjectedFault,
        ModelRegistry,
    )
    from repro_torch.kernels.predict import packed_predict, packed_predict_early_exit
    from repro_torch.launch import fleet as fleet_cli
    from repro_torch.launch import serve

    root = Path(tmp)
    fdir, edir, sdir = root / "fleet", root / "ee_fleet", root / "swap"
    for p in (fdir, edir, sdir):
        p.mkdir()
    # ---- 0. the fleets, built on host processes ---------------------------
    tasks = ([("syn", 10 + k, str(fdir), FLEET_RUNGS, k < 2) for k in range(N_FLEET_FORESTS)]
             + [("ee", 30 + k, str(edir), FLEET_RUNGS, False) for k in range(N_FLEET_FORESTS)]
             + [("syn", 99, str(sdir), ("exact",), False)])
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        rung_s = np.array([t for times in pool.map(build_ladder, tasks)
                           for t in times.values()])
    build_s = time.perf_counter() - t0
    target = str(sdir / "syn99_exact.toad")
    names = sorted(p.name for p in fdir.iterdir())
    sizes = [os.path.getsize(fdir / n) for n in names]
    print(f"[fleet] built {len(names)} artifacts ({N_FLEET_FORESTS} synthetic forests x "
          f"{len(FLEET_RUNGS)} rungs {FLEET_RUNGS}, two also as 32-block .toadpack; "
          f"{min(sizes)}-{max(sizes)} B a file), {len(os.listdir(edir))} early-exit ones "
          f"and a swap target in {build_s:.1f} s on {workers} host processes; compress + "
          f"save a rung {rung_s.min():.2f} / {np.median(rung_s):.2f} / {rung_s.max():.2f} s "
          f"(min / median / max, a process's one thread)")

    # ---- 1. admission and refusal through the fleet CLI -------------------
    t0 = time.perf_counter()
    res = _fleet_cli("--models", str(fdir), "--dry-run")
    dry_s = time.perf_counter() - t0
    lines = res.stdout.splitlines()
    adm = [ln.strip() for ln in lines if ln.strip().startswith("admitted ") and " from " in ln]
    adm_ms = np.array([float(ln.rsplit(" in ", 1)[1].split()[0]) for ln in adm])
    is_pack = np.array(["streaming" in ln for ln in adm])
    pack_ms, adm_ms = adm_ms[is_pack], adm_ms[~is_pack]
    plan = [ln for ln in lines if ln.startswith("planned residency")]
    if res.returncode != 0 or len(adm) != len(names) or not plan:
        raise SystemExit(f"[fleet] the dry run failed (rc {res.returncode}):\n"
                         f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    print(f"[fleet] python -m repro_torch.launch.fleet --models DIR --dry-run (a "
          f"subprocess, {dry_s:.1f} s): {lines[0]}; admission ms a model (verify_fleet "
          f"ran before, not counted): classic {np.min(adm_ms):.1f} / "
          f"{np.median(adm_ms):.1f} / {np.max(adm_ms):.1f} (min / median / max), sum "
          f"{adm_ms.sum():.0f}; the packs {' '.join(f'{m:.1f}' for m in pack_ms)}; "
          f"{plan[0]}")
    bad_dir = root / "fleet_bad"
    shutil.copytree(fdir, bad_dir)
    victim = bad_dir / names[5]
    with np.load(victim) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    arrays["toad_stream"][len(arrays["toad_stream"]) // 2] ^= 0x5A
    with open(victim, "wb") as f:
        np.savez_compressed(f, **arrays)
    res = _fleet_cli("--models", str(bad_dir), "--dry-run")
    others = [n for n in names if n != victim.name and n in res.stderr]
    print(f"[fleet] the directory with one stream byte flipped in {victim.name}: exit "
          f"{res.returncode}; {res.stderr.strip().splitlines()[0][:160]} ... names "
          f"{victim.name}: {victim.name in res.stderr}, any other file: {others}")
    if (res.returncode != 1 or "fleet admission refused" not in res.stderr
            or victim.name not in res.stderr or "TOAD106" not in res.stderr or others):
        raise SystemExit("[fleet] the corrupted directory was not refused naming its file")
    shutil.rmtree(bad_dir)

    # ---- 2. dedup on the card: one tensor a shared table ------------------
    def shared():
        reg = ModelRegistry.from_dir(str(fdir), device=dev)
        FleetEngine(reg, max_hot=len(reg)).warm()  # predictors built, nothing run
        return reg

    def apart():
        regs = []
        for n in names:
            r = ModelRegistry(device=dev)
            r.register(Path(n).stem, str(fdir / n))
            FleetEngine(r).warm()
            regs.append(r)
        return regs

    reg, grow_shared, shared_s = _cuda_growth(dev, shared)
    regs, grow_apart, apart_s = _cuda_growth(dev, apart)
    del regs
    ds = reg.pool.device_stats()[str(dev)]
    report = reg.memory_report()
    gap = grow_apart - grow_shared
    one_ptr = one_cb = 0
    for k in range(N_FLEET_FORESTS):
        ladder = [reg.get(f"syn{10 + k:02d}_{r}") for r in FLEET_RUNGS[:3]]
        one_ptr += len({e.model.device_packed().thr_table.data_ptr() for e in ladder}) == 1
        one_cb += ladder[0].thr_codebook_table is ladder[1].thr_codebook_table \
            is ladder[2].thr_codebook_table
    leaf_shared = [
        reg.get(f"syn{10 + k:02d}_cbl4_pack").model.scorer._leaf_values.data_ptr()
        == reg.get(f"syn{10 + k:02d}_cbl4").model.device_packed().leaf_values.data_ptr()
        for k in range(2)]
    print(f"[fleet] dedup on {dev}: the 3 codebook rungs of a forest pass one thr_table "
          f"data_ptr() in {one_ptr} of {N_FLEET_FORESTS} forests, one thr_codebook_table "
          f"object in {one_cb}; a pack and its classic rung share the leaf_values tensor: "
          f"{leaf_shared}; the pool holds {ds['n_tensors']} tensors on the card "
          f"({ds['n_shared_tensors']} shared, {ds['saved_copies']} copies spared, "
          f"{ds['dedup_saved_bytes']:.0f} B)")
    print(f"[fleet] memory_allocated growth, the fleet admitted and warmed: one shared pool "
          f"{grow_shared} B ({shared_s:.1f} s), one pool a model {grow_apart} B "
          f"({apart_s:.1f} s): gap {gap} B against the pool's {ds['dedup_saved_bytes']:.0f} "
          f"B on the card (tolerance 512 B x {ds['saved_copies']} copies, the allocator's "
          f"rounding); the report: {report['standalone_total_bytes']:.0f} B standalone -> "
          f"{report['fleet_resident_bytes']:.0f} B fleet, dedup_saved_bytes "
          f"{report['dedup_saved_bytes']:.0f} B, of which "
          f"{report['dedup_saved_bytes'] - ds['dedup_saved_bytes']:.0f} B are host-only "
          f"tables (threshold codebooks, the packs' threshold tables)")
    if (one_ptr != N_FLEET_FORESTS or one_cb != N_FLEET_FORESTS or not all(leaf_shared)
            or not 0 < grow_shared < grow_apart
            or abs(gap - ds["dedup_saved_bytes"]) > 512 * ds["saved_copies"]):
        raise SystemExit("[fleet] the card's copies are not shared as the pool says")

    # ---- 3. routed traffic through the fleet CLI and the serve CLI --------
    n_models = len(names)
    swap_id = "syn12_exact"
    cli_runs = {}
    for label, entry, extra in (
            ("python -m repro_torch.launch.fleet", fleet_cli.main, []),
            ("python -m repro_torch.launch.serve --arch toad-fleet --streaming",
             serve.main, ["--arch", "toad-fleet", "--streaming"])):
        packed_predict.launches = 0
        out = entry([*extra, "--models", str(fdir), "--requests", str(N_SERVE),
                     "--clients", "4", "--max-hot", str(n_models),
                     "--swap", f"{swap_id}={target}"])
        b1 = packed_predict.launches
        f = out["stats"]["fleet"]
        streamed = {m: s["score_is_final"] for m, s in out["stats"]["streaming"].items()}
        print(f"[fleet] {label} --requests {N_SERVE} --clients 4 --max-hot {n_models} "
              f"--swap {swap_id}=<target>: {out['n_served']} routed requests over "
              f"{n_models} models, {out['req_per_s']:.1f} req/s, p50 "
              f"{f['latency_p50_ms']:.2f} ms, p95 {f['latency_p95_ms']:.2f} ms, mean batch "
              f"{f['mean_batch']:.2f}, {f['n_batches']} batches, "
              f"{out['stats']['n_retired']} retired backends, fallback batches "
              f"{f['n_fallback_batches']}; parity {out['max_err']:.2e}; swapped "
              f"{out['swapped']}; packs final {streamed}; admission {out['admission_s']:.1f} "
              f"s; packed_predict launches {b1}; card: {smi}")
        if (out["n_served"] != N_SERVE or out["max_err"] > 1e-5 or f["n_fallback_batches"]
                or b1 < f["n_batches"] or out["swapped"] != {swap_id: 2}
                or not all(streamed.values())):
            raise SystemExit(f"[fleet] {label} broke its contract")
        cli_runs[label] = dict(out, b1=b1)

    # ---- 4. the LRU and a swap's drain, at the engine ---------------------
    classic = [m for m in reg.ids() if not reg.get(m).is_streaming]
    probe = {m: fleet_cli._probe_queries(reg.get(m).model, 64) for m in classic}
    ref = {m: reg.get(m).model.predict(probe[m], backend="reference") for m in classic}
    with FleetEngine(reg, max_hot=8, max_wait_ms=1.0) as eng:
        futs = [(m, j, eng.submit(m, probe[m][j]))
                for _ in range(2) for m in classic for j in range(16)]
        lru_err = max(float(np.abs(fut.result(timeout=120) - ref[m][j]).max())
                      for m, j, fut in futs)
        eng.drain()
        lru = eng.stats()
    print(f"[fleet] FleetEngine(max_hot=8) over {len(classic)} classic models, 16 requests "
          f"each in a fixed route order, twice: {len(futs)} futures resolved within "
          f"{lru_err:.2e} of each model's reference; {lru.n_retired} backends retired "
          f"(evictions), {lru.n_hot} hot")
    # a cyclic route order over n > 8 models misses every time: n - 8 evictions
    # in the first pass and n in the second
    if lru_err > 1e-5 or lru.n_retired < 2 * len(classic) - 8 or lru.n_hot != 8:
        raise SystemExit("[fleet] the LRU did not evict and serve")
    mid = classic[0]
    with FleetEngine(reg, max_wait_ms=1.0) as eng:
        eng.warm(mid)
        before = eng.version(mid)
        old_futs = [eng.submit(mid, x) for x in probe[mid]]
        entry = eng.swap(mid, target)
        new_futs = [eng.submit(mid, x) for x in probe[mid]]
        got_old = np.stack([f.result(timeout=60) for f in old_futs])
        got_new = np.stack([f.result(timeout=60) for f in new_futs])
        eng.drain()
    new_ref = entry.model.predict(probe[mid], backend="reference")
    errs = (float(np.abs(got_old - ref[mid]).max()), float(np.abs(got_new - new_ref).max()))
    apart_by = float(np.abs(ref[mid] - new_ref).max())
    print(f"[fleet] 64 submits to {mid}, a swap, 64 submits: v{before} -> v{entry.version}; "
          f"old futures within {errs[0]:.2e} of the old version, new within {errs[1]:.2e} "
          f"of the new (the versions differ by up to {apart_by:.3f})")
    if max(errs) > 1e-5 or apart_by < 1e-4 or entry.version != before + 1:
        raise SystemExit("[fleet] the swap did not drain the old version")

    # ---- 5. early exit through the fleet CLI (B3) --------------------------
    packed_predict_early_exit.launches = 0
    ee = fleet_cli.main(["--models", str(edir), "--early-exit", "0", "--requests",
                         str(N_SERVE), "--clients", "4", "--max-hot", "32"])
    b3 = packed_predict_early_exit.launches
    f = ee["stats"]["fleet"]
    print(f"[fleet] python -m repro_torch.launch.fleet --early-exit 0 over the "
          f"{len(os.listdir(edir))} early-exit models: "
          f"{ee['n_served']} requests, {ee['req_per_s']:.1f} req/s, p50 "
          f"{f['latency_p50_ms']:.2f} ms, p95 {f['latency_p95_ms']:.2f} ms, mean batch "
          f"{f['mean_batch']:.2f}; mean trees evaluated {f['mean_trees_evaluated']:.3f} of "
          f"256 over {f['n_early_exit_rows']} rows; label mismatches "
          f"{ee['label_mismatches']}; packed_predict_early_exit launches {b3} for "
          f"{f['n_batches']} batches")
    if (ee["label_mismatches"] != 0 or b3 < f["n_batches"] or f["n_fallback_batches"]
            or not 0 < f["mean_trees_evaluated"] < 256):
        raise SystemExit("[fleet] the early-exit fleet broke its contract")

    # ---- 6. streaming: the packs' first wave, then final scores -----------
    pdir = root / "packs"
    pdir.mkdir()
    for n in names:
        if n.endswith(".toadpack"):
            shutil.copy(fdir / n, pdir / n)
    preg = ModelRegistry.from_dir(str(pdir), streaming=True, device=dev)
    first = {}
    for m in preg.ids():
        r = preg.get(m).model.scorer.predict(fleet_cli._probe_queries(preg.get(m).model, 64))
        first[m] = f"{r.blocks_evaluated}/{r.n_blocks}"
    with FleetEngine(preg, streaming=True, max_wait_ms=1.0) as eng:
        done = eng.wait_complete(timeout=120)
        s_err = 0.0
        for m in preg.ids():
            x = fleet_cli._probe_queries(preg.get(m).model, 64)
            got = np.stack([fut.result(timeout=60) for fut in [eng.submit(m, r) for r in x]])
            s_err = max(s_err, float(np.abs(got - preg.get(m).model.predict(
                x, backend="reference")).max()))
        st = eng.stats()
    print(f"[fleet] streaming admission of the two packs: first-wave blocks {first} right "
          f"after admission; then complete ({done}), routed scores within {s_err:.2e} of "
          f"the host reference; served by {st.active_backend} (the torch traversal)")
    if not done or s_err > 1e-5 or set(st.active_backend.values()) != {"packed"}:
        raise SystemExit("[fleet] the streaming entries broke their contract")
    del preg

    # ---- 7. chaos ---------------------------------------------------------
    ledger = FutureLedger()
    m0, m1, m2 = classic[1], classic[2], classic[3]

    def batch(eng, m, k):
        x = probe[m][8 * k: 8 * k + 8]
        got = np.stack([ledger.track(eng.submit(m, r)).result(timeout=60) for r in x])
        return float(np.abs(got - ref[m][8 * k: 8 * k + 8]).max())

    reg._faults = FaultPlan([Fault(point="admit", model=m0, message="load error mid-swap")])
    with FleetEngine(reg, max_wait_ms=1.0) as eng:
        before = eng.version(m0)
        err0 = batch(eng, m0, 0)
        try:
            eng.swap(m0, target)
            raise SystemExit("[fleet] the faulted swap landed")
        except InjectedFault:
            pass
        after = eng.version(m0)
        err1 = batch(eng, m0, 1)
    reg._faults = None
    print(f"[fleet] an admit fault mid-swap of {m0}: InjectedFault, still v{after} "
          f"(was v{before}), serving within {max(err0, err1):.2e}")
    if after != before or max(err0, err1) > 1e-5:
        raise SystemExit("[fleet] the failed swap did not leave the old version serving")

    plan = FaultPlan([Fault(point="predict", model=m0, backend="cuda", count=3,
                            message="injected kernel fault")])
    policy = ResiliencePolicy(fallback=True, max_retries=0, breaker_threshold=3,
                              breaker_cooldown_ms=60_000.0)
    with FleetEngine(reg, policy=policy, faults=plan, max_wait_ms=1.0) as eng:
        errs = [batch(eng, m, k) for k in range(4) for m in (m0, m1, m2)]
        s = eng.stats()
    print(f"[fleet] 3 injected cuda faults on {m0}: breakers "
          f"{ {m: s.breaker_state[m]['cuda'] for m in (m0, m1, m2)} }, active "
          f"{s.active_backend}, fallback batches {s.per_model[m0].n_fallback_batches}; "
          f"every batch within {max(errs):.2e}")
    if (s.breaker_state[m0]["cuda"] != "open" or s.active_backend[m0] != "packed"
            or any(s.active_backend[m] != "cuda" or s.breaker_state[m]["cuda"] != "closed"
                   for m in (m1, m2))
            or max(errs) > 1e-5 or plan.n_fired("predict") != 3):
        raise SystemExit("[fleet] the faults did not open the one model's breaker only")

    plan = FaultPlan([Fault(point="worker", model=m1, at=(1,), count=1)])
    with FleetEngine(reg, policy=ResiliencePolicy(restart_budget=2, fallback=False),
                     faults=plan, max_wait_ms=1.0) as eng:
        # one request alone: the worker's occurrence 0; the next batch is 1
        err0 = float(np.abs(ledger.track(eng.submit(m1, probe[m1][0])).result(timeout=60)
                            - ref[m1][0]).max())
        crashed = [ledger.track(eng.submit(m1, r)) for r in probe[m1][8:16]]
        outcomes = {type(fut.exception(timeout=60)).__name__ for fut in crashed}
        err1 = batch(eng, m1, 2)
        s = eng.stats()
    print(f"[fleet] a worker fault on {m1}: in-flight outcomes {sorted(outcomes)}, "
          f"{s.per_model[m1].n_worker_restarts} restart, then served on "
          f"{s.active_backend[m1]} within {max(err0, err1):.2e}")
    if (s.per_model[m1].n_worker_restarts != 1 or "WorkerCrashed" not in outcomes
            or s.active_backend[m1] != "cuda" or max(err0, err1) > 1e-5):
        raise SystemExit("[fleet] the worker was not restarted")
    ledger.assert_all_resolved(timeout=10.0)
    print(f"[fleet] FutureLedger: all {len(ledger)} futures resolved "
          f"{ledger.outcomes(timeout=0)}")
    del reg
    return {"b1": {k: v["b1"] for k, v in cli_runs.items()}, "b3": b3}


# ---- slices 9-10: the LM serving path --------------------------------------
LM_B, LM_S, LM_STEPS = 4, 32, 4  # card = CPU on the reduced configs
LM_ARGMAX, LM_ATOL, LM_RTOL = 0.95, 0.15, 0.1  # test_archs.py's decode bound
# Limits set from the H100's readings that PERF.md records (card = CPU
# max|Δ| <= 0.02344; qwen3-4b decode vs prefill max|Δ| 0.08984; int8 cache
# agreement 0.9609, relative error 0.02721), with room on both sides.
LM_CARD_MAX_ABS = 0.0625  # the JAX-parity tests' logit atol
QWEN_DECODE_MAX_ABS = 0.25
INT8_AGREE, INT8_REL = 0.9, 0.05  # 0.05: test_archs.py's int8 bound
QWEN_ARGS = ("--arch", "qwen3-4b", "--batch", "4", "--prompt-len", "512",
             "--decode-steps", "32")
OLMOE_ARGS = ("--arch", "olmoe-1b-7b", "--batch", "4", "--prompt-len", "128",
              "--decode-steps", "8")
# Slice 10 at full width and depth through the serve CLI: (argv, decode steps
# held to a fresh prefill, the cuts to the run's size).  recurrentgemma's
# second run passes its 2,048-token window, so the ring wraps.
SLICE10_RUNS = (
    (("--arch", "rwkv6-1.6b", "--batch", "4", "--prompt-len", "512", "--decode-steps", "32"),
     4, "nothing cut"),
    (("--arch", "recurrentgemma-9b", "--batch", "4", "--prompt-len", "512",
      "--decode-steps", "32"), 4, "nothing cut"),
    (("--arch", "recurrentgemma-9b", "--batch", "1", "--prompt-len", "2560",
      "--decode-steps", "8"), 2,
     "batch 1 and 8 steps: a run past the window, not a throughput run"),
    (("--arch", "whisper-small", "--batch", "4", "--prompt-len", "512",
      "--decode-steps", "32"), 4, "nothing cut; 256 encoder frames of ones, the JAX CLI's"),
)
# The JAX-parity tests' logit bounds (tests/test_torch_lm_*.py): on weights
# whose constant entries are redrawn, the card is held to the CPU by these.
REDRAWN_MAX_ABS = {"rwkv": 0.125, "hybrid": 0.25, "encdec": 0.0625}
# Slice 10's bf16 decode at S+i against a fresh prefill over S+i+1 tokens,
# as served: (argmax agreement >=, max|Δ| <=).  qwen3-4b's gate, but for
# RWKV-6, whose limits are set from the readings of an NVIDIA H100 80GB
# HBM3 at 700 W (agreement 0.625,
# max|Δ| 0.5885 here; 0.875-0.9375 and 0.568-0.861 on other tokens, PERF.md
# §6): the card picks another product kernel (cuBLAS) and another
# reduction order (PyTorch's mean) for decode's B rows than for a
# prefill's B*(S+i+1), the two round apart by an ulp, and the random-weight
# residual stream grows that to 0.04 of its norm over 24 layers.  The
# witness, gated exactly: the same decode with those operations run at the
# prefill's rows (``_rows_matched``) equals the prefill.
SLICE10_DECODE = {"rwkv": (0.5, 1.0), "hybrid": (LM_ARGMAX, QWEN_DECODE_MAX_ABS),
                  "encdec": (LM_ARGMAX, QWEN_DECODE_MAX_ABS)}


def _to(tree, dev):
    """A nest of dicts and lists of tensors, each moved to ``dev``."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return [_to(v, dev) for v in tree]


def _redraw_constants(tree, seed: int) -> None:
    """Every constant entry of a parameter tree (what ``init`` draws as
    zeros or ones: norms, biases, token-shift mixes, the conv kernel, Λ,
    the gates, the decay) redrawn in place as c + 0.25 N(0, 1), seeded, in
    its own dtype: with ``init``'s zero conv kernel the RG-LRU's input is
    zero, and with zero mixes RWKV's token shift is unused."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    for _, t in _named_tensors(tree):
        if bool(t.amin() == t.amax()):
            noise = torch.randn(t.shape, generator=gen) * 0.25
            t.copy_((t.float().cpu() + noise).to(t.dtype))


def _lm_prompt(cfg, B: int, S: int, seed: int = 0) -> dict:
    """A seeded prompt as CPU tensors (a VLM's patch embeddings, whisper's
    encoder frames included)."""
    import torch

    from repro_torch.launch.serve import lm_layout

    rng = np.random.default_rng(seed)
    side, n_side, n_text = lm_layout(cfg, S)
    batch = {} if side is None else {side: torch.from_numpy(
        rng.normal(size=(B, n_side, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)}
    batch["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, n_text)))
    return batch


def lm_card_equals_cpu(dev, name: str, redraw: bool = False) -> dict:
    """The reduced ``name`` with the same seeded weights on the card and on
    the port's CPU path, each through a model of its own device (which
    refuses tensors from the other): prefill logits and ``LM_STEPS`` decode
    steps, both fed the CPU's tokens.  Returns max|Δ| and the argmax agreement over
    every logit row, and whether the decode bound holds (with ``redraw``,
    the constant entries redrawn and max|Δ| alone held to the family's
    JAX-parity bound, ``REDRAWN_MAX_ABS``, which leaves the argmax equal
    wherever the top two logits are twice that apart)."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import get_model

    cfg = get_reduced(name)
    cpu, card = get_model(cfg, "cpu"), get_model(cfg, dev)
    params = cpu.init(0)
    if redraw:
        _redraw_constants(params, 1)
    on_card = _to(params, dev)
    batch = _lm_prompt(cfg, LM_B, LM_S)
    max_seq = LM_S + LM_STEPS  # a VLM's patch slots and text make LM_S
    la, ca = cpu.prefill(params, batch, max_seq=max_seq)
    lb, cb = card.prefill(on_card, {k: v.to(dev) for k, v in batch.items()}, max_seq=max_seq)
    rows_a, rows_b = [la], [lb]
    for _ in range(LM_STEPS):
        tok = torch.argmax(rows_a[-1][:, : cfg.vocab], -1)
        la, ca = cpu.decode_step(params, ca, tok)
        lb, cb = card.decode_step(on_card, cb, tok.to(dev))
        rows_a.append(la)
        rows_b.append(lb)
    a = torch.cat(rows_a)[:, : cfg.vocab].numpy()
    b = torch.cat(rows_b)[:, : cfg.vocab].float().cpu().numpy()
    agree = float(np.mean(a.argmax(-1) == b.argmax(-1)))
    max_abs = float(np.abs(a - b).max())
    limit = REDRAWN_MAX_ABS[cfg.family] if redraw else LM_CARD_MAX_ABS
    ok = max_abs <= limit and (redraw or (
        agree >= LM_ARGMAX and bool(np.allclose(b, a, atol=LM_ATOL, rtol=LM_RTOL))))
    return {"name": name, "max_abs": max_abs, "agree": agree, "limit": limit, "ok": ok}


def _lm_step_bytes(cfg, B: int, max_seq: int, enc_seq: int = 0) -> dict:
    """Bytes one decode step must move at batch ``B``: the weights it reads,
    each entry at its stored dtype (the f32 entries at 4 B), the embedding
    table counted whole where the head is tied to it (whisper) and else the
    ``B`` rows gathered, whisper's encoder and its decoder's cross-attention
    k/v projections left out (decode never runs them: it reads the cached
    xk/xv);
    every cache tensor read once; a recurrent state (RWKV's s/xt/xc, the
    RG-LRU's conv/lru) written once.  The one new k/v slot a layer writes
    is left out (< 0.01 % of the step)."""
    from repro_torch.models import param_shapes
    from repro_torch.models.registry import get_module

    mod = get_module(cfg)
    shapes = param_shapes(cfg)
    tied = "head" not in shapes["top"]

    def weights(tree, name=""):
        if isinstance(tree, dict):
            return sum(weights(v, k) for k, v in tree.items()
                       if k not in ("enc", "x_wk", "x_wv", "x_bv")
                       and not k.startswith("ln_enc") and (tied or k != "embed"))
        if isinstance(tree, list):
            return sum(weights(v, name) for v in tree)
        return int(np.prod(tree)) * (4 if name in mod.F32_ENTRIES else 2)

    kw = {"enc_seq": enc_seq} if cfg.family == "encdec" else {}
    cache = mod.alloc_cache(cfg, B, max_seq, "meta", **kw)
    read = written = 0
    for name, t in _named_tensors(cache):
        n = t.numel() * t.element_size()
        read += n
        written += n if name in ("s", "xt", "xc", "conv", "lru") else 0
    w = weights(shapes)
    gather = 0 if tied else 2 * B * cfg.d_model
    total = w + read + written + gather
    return {"weights": w, "cache_read": read, "state_written": written, "gather": gather,
            "total": total, "bound_ms": total / HBM_BYTES_PER_S * 1e3}


def _named_tensors(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_tensors(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _named_tensors(v, name)
    elif hasattr(tree, "numel"):
        yield name, tree


def _profile(run, n: int) -> str:
    """Wall ms, device-busy share and kernels a call of ``n`` calls of
    ``run(i)`` under ``torch.profiler``."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    kernels = sum(e.count for e in rows)
    if busy_ms <= 0:
        return f"wall {wall_ms / n:.3f} ms a call; device time not measured"
    return (f"wall {wall_ms / n:.3f} ms a call, device busy {busy_ms / n:.3f} ms "
            f"({100 * busy_ms / wall_ms:.1f} %), {kernels / n:.0f} kernels a call")


def _rows_matched(rows: int, skip_cols: int, reductions: bool = True):
    """A ``TorchFunctionMode`` that runs every operation whose rounding
    depends on how many rows run together at a prefill's row count: a
    (B, 1, ...) operand of a product (``x @ W``) or of a reduction over the
    last dimension (``torch.mean``, ``torch.var``) is padded with zero rows
    to (B, rows, ...), the real row last, and that row's result returned.
    The card picks a product's kernel (cuBLAS) and a reduction's summation
    order (PyTorch) by the row count, so a decode step's row under this
    mode rounds as the last row of a prefill over ``rows`` tokens does.
    The head's product (``skip_cols`` columns) has B rows in a decode step
    and in a prefill and is left alone; with ``reductions`` false only the
    products are padded.  ``padded`` counts the operations it padded."""
    import torch
    from torch.overrides import TorchFunctionMode

    mm = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)  # `a @ b`
    red = (torch.mean, torch.var)

    class RowsMatched(TorchFunctionMode):
        padded = 0

        def _pad(self, a):
            self.padded += 1
            return torch.cat([a.new_zeros((a.shape[0], rows - 1) + a.shape[2:]), a], 1)

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            a = args[0] if args else None
            if isinstance(a, torch.Tensor) and a.dim() >= 3 and a.shape[1] == 1:
                if (func in mm and not kwargs and args[1].dim() == 2
                        and args[1].shape[1] != skip_cols):
                    return func(self._pad(a), args[1])[:, -1:]
                dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
                if (reductions and func in red and dim in (-1, a.dim() - 1)
                        and kwargs.get("keepdim")):
                    return func(self._pad(a), *args[1:], **kwargs)[:, -1:]
            return func(*args, **kwargs)

    return RowsMatched()


@contextlib.contextmanager
def f32_products():
    """Inside, every bf16 product (``matmul``, ``@``, ``bmm``, ``einsum``)
    is computed in float32 with TF32 off and rounded to bf16 once, and
    every other operation runs as it is: two runs that differ only in how
    their products round (cuBLAS's kernel and split for a shape, a mesh's
    float32 partial sums) then differ by far less.  Float32 products are
    left alone (the mesh's row-parallel products are float32 already)."""
    import torch
    from torch.overrides import TorchFunctionMode

    mm = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.bmm)

    class F32Products(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in mm and args[0].dtype == torch.bfloat16:
                return func(args[0].float(), args[1].float(), **kwargs).to(torch.bfloat16)
            if func is torch.einsum:
                ops = args[1] if len(args) == 2 and isinstance(args[1], (list, tuple)) \
                    else args[1:]
                if ops and all(o.dtype == torch.bfloat16 for o in ops):
                    return func(args[0], *[o.float() for o in ops]).to(torch.bfloat16)
            return func(*args, **kwargs)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with F32Products():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def blocks_matched(cfg, params, n_model: int, reverse: bool = False):
    """A ``TorchFunctionMode`` for a one-device run on ``params`` (bf16
    serving weights) that computes each ``x @ W`` whose weight a mesh of
    ``n_model`` ranks on ``"model"`` splits as that mesh computes it: a
    column-parallel weight's (its last dimension split) as the products of
    its ``n_model`` column blocks, each block contiguous as a rank holds
    it, concatenated; a row-parallel weight's (the contracted dimension
    split) as ``layers.row_parallel`` does, the blocks' float32 partial
    products summed in float32, in rank order, and rounded once.  The
    card picks a product's kernel by its shape, so the one device's
    products then round as the ranks' do; only the order of the mesh's
    float32 all-reduce is left.  ``reverse`` sums the partials in the
    reverse order: two one-device runs that differ in that order alone
    differ as a mesh's all-reduce order can.  A weight is told by its
    storage (``W`` is ``params``' tensor, or one layer of a stacked one);
    ``hits`` counts the products it split."""
    import torch
    from torch.overrides import TorchFunctionMode

    from repro_torch.models.base import map_leaves, param_specs

    roles = {}

    def visit(_, t, spec):
        if t.dim() < 2 or spec[-2:] == (None, None):
            return
        role = ("col" if "model" in str(spec[-1]) else
                "row" if "model" in str(spec[-2]) else None)
        for w in (t.unbind(0) if t.dim() == 3 else (t,)):
            roles[w.data_ptr()] = role

    map_leaves(visit, params, param_specs(cfg))
    mm = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)

    class BlocksMatched(TorchFunctionMode):
        hits = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in mm and not kwargs and args[1].dim() == 2:
                a, w = args
                role = roles.get(w.data_ptr())
                if role == "col":
                    self.hits += 1
                    return torch.cat([a @ b.contiguous() for b in w.chunk(n_model, 1)], -1)
                if role == "row":
                    self.hits += 1
                    parts = [x.float() @ b.float() for x, b in
                             zip(a.chunk(n_model, -1), w.chunk(n_model, 0))]
                    if reverse:
                        parts.reverse()
                    total = parts[0]
                    for p in parts[1:]:
                        total = total + p
                    return total.to(a.dtype)
            return func(*args, **kwargs)

    return BlocksMatched()


def _decode_vs_fresh(cfg, model, params, out, n_check: int, matched: bool = False):
    """The CLI's prompt, side input and decoded tokens replayed through
    ``model`` on ``params``: prefill, then ``n_check`` decode steps at S+i,
    each against a fresh prefill over S+i+1 tokens (with ``matched``, both
    under ``_rows_matched`` at that prefill's rows).
    Returns the decode logits, the cache, the argmax agreement and max|Δ|
    over the ``B * n_check`` rows and the operations the decode steps
    padded."""
    import torch

    dev = model.device
    extra = out["side"]
    prompt = torch.from_numpy(out["prompt"]).to(dev)
    toks = torch.from_numpy(out["tokens"]).to(dev)
    S, steps = out["prompt_len"], out["decode_steps"]
    logits, cache = model.prefill(params, {"tokens": prompt, **extra}, max_seq=S + steps)
    dec, padded = [], 0
    for i in range(n_check):
        mode = (_rows_matched(S + i + 1, cfg.padded_vocab) if matched
                else contextlib.nullcontext())
        with mode:
            logits, cache = model.decode_step(params, cache, toks[:, i])
        padded += getattr(mode, "padded", 0)
        dec.append(logits[:, : cfg.vocab].float())
    agree, max_abs = [], 0.0
    for i in range(n_check):
        mode = (_rows_matched(S + i + 1, cfg.padded_vocab) if matched
                else contextlib.nullcontext())
        with mode:
            fresh, _ = model.prefill(params, {"tokens": torch.cat([prompt, toks[:, : i + 1]], 1),
                                              **extra})
        fresh = fresh[:, : cfg.vocab].float()
        agree.append((fresh.argmax(-1) == dec[i].argmax(-1)).float().mean().item())
        max_abs = max(max_abs, (fresh - dec[i]).abs().max().item())
        del fresh
    return dec, cache, float(np.mean(agree)), max_abs, padded


def slice10_full_width(dev, smi: str, argv, n_check: int, cuts: str) -> dict:
    """One slice-10 architecture at full width and depth through the serve
    CLI (seed-0 weights), its timings beside the decode step's bytes bound
    and the CLI's first step replayed on its weights.  Then, with the
    constant entries redrawn (``_redraw_constants``), its first ``n_check``
    bf16 decode steps against fresh prefills, gated at ``SLICE10_DECODE``;
    for RWKV-6 also with decode's products padded to the prefill's rows,
    gated to equal the prefill exactly."""
    import gc

    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import count_params, get_model, param_shapes

    out = serve.main(list(argv))
    name = out["arch"]
    cfg = get_reduced(name) if "--reduced" in argv else get_config(name)
    if out["device"].split(":")[0] != dev.type:
        raise SystemExit(f"[lm] {name} served on {out['device']}")
    first = out["first_logits"][:, : cfg.vocab]
    B, S, steps = out["batch"], out["prompt_len"], out["decode_steps"]
    enc = S // cfg.frontend_len_div if cfg.family == "encdec" else 0
    bound = _lm_step_bytes(cfg, B, S + steps, enc)
    print(f"[lm] {name} full width ({count_params(param_shapes(cfg)):,} parameters, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}; {cuts}): batch {B}, prompt {S}, "
          f"{steps} decode steps; prefill {out['prefill_ms']:.3f} ms, decode "
          f"{out['decode_ms_median']:.3f} ms/step (median after the first; first "
          f"{out['decode_ms'][0]:.3f}), {out['tok_per_s']:.1f} tok/s, peak memory_allocated "
          f"{out['peak_bytes'] or 0:,} B; decode bytes bound {bound['bound_ms']:.4f} ms "
          f"({bound['weights']:,} B of weights + {bound['cache_read']:,} B of cache read + "
          f"{bound['state_written']:,} B of state written + {bound['gather']:,} B gathered, "
          f"at 3.35 TB/s), decode/bound {out['decode_ms_median'] / bound['bound_ms']:.1f}x; "
          f"finite logits {bool(np.isfinite(first).all())}; card: {smi}")
    if not np.isfinite(first).all():
        raise SystemExit(f"[lm] {name}: non-finite logits")

    model = get_model(cfg, dev)
    params = model.init(serve.LM_SEED)  # the CLI's weights
    toks = torch.from_numpy(out["tokens"]).to(dev)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(out["prompt"]).to(dev),
                                           **out["side"]}, max_seq=S + steps)
    logits, _ = model.decode_step(params, cache, toks[:, 0])
    same = float(np.abs(logits[:, : cfg.vocab].float().cpu().numpy() - first).max())
    del logits, cache
    _redraw_constants(params, 1)
    _, cache, agreement, max_abs, _ = _decode_vs_fresh(cfg, model, params, out, n_check)
    if dev.type == "cuda":
        cache["length"] = S  # the profiled steps rewrite positions S..S+3
        prof = _profile(lambda i: model.decode_step(params, cache, toks[:, i]), 4)
        print(f"[lm] {name} decode under torch.profiler (4 steps, the profiler's own cost "
              f"included): {prof}; card: {smi}")
        if cfg.family == "rwkv":
            prompt = torch.from_numpy(out["prompt"]).to(dev)
            prof = _profile(lambda i: model.prefill(params, {"tokens": prompt}), 1)
            print(f"[lm] {name} prefill (the sequential WKV: {S} steps x {cfg.n_layers} "
                  f"layers) under torch.profiler: {prof}; card: {smi}")
    del cache
    min_agree, limit = SLICE10_DECODE[cfg.family]
    line = (f"[lm] {name} (batch {B}, prompt {S}) on redrawn constant entries: bf16 decode "
            f"at S+i vs a fresh prefill over S+i+1 tokens, i < {n_check} ({B * n_check} "
            f"logit rows): argmax agreement {agreement:.4f} (gate >= {min_agree}), max|Δ| "
            f"{max_abs:.4g} (gate <= {limit})")
    matched = None
    if cfg.family == "rwkv":
        _, _, m_agree, m_abs, padded = _decode_vs_fresh(cfg, model, params, out, n_check,
                                                        matched=True)
        matched = {"agreement": m_agree, "max_abs": m_abs, "padded": padded}
        line += (f"; with {padded} products and row reductions of the decode steps (and "
                 f"the prefills' final norm) run at the prefill's rows: argmax agreement "
                 f"{m_agree:.4f}, max|Δ| {m_abs:.4g} (gate: equal)")
    print(f"{line}; the CLI's first step replayed on its weights: max|Δ| {same:.3g}; "
          f"card: {smi}")
    if agreement < min_agree or max_abs > limit:
        raise SystemExit(f"[lm] {name} decode leaves prefill: agreement {agreement}, "
                         f"max|Δ| {max_abs}")
    if matched is not None and (matched["max_abs"] != 0.0 or matched["padded"] == 0):
        raise SystemExit(f"[lm] {name} decode with products matched to the prefill's rows "
                         f"leaves the prefill: {matched}")
    del params, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"arch": name, "batch": B, "prompt_len": S, "bound_ms": bound["bound_ms"],
            "agreement": agreement, "max_abs": max_abs, "matched": matched,
            **{k: out[k] for k in ("prefill_ms", "decode_ms_median", "tok_per_s",
                                   "peak_bytes")}}


def lm_phase(dev, smi: str) -> dict:
    """Slices 9 and 10 on the card: the 10 reduced configs on the card
    against the CPU path (the 3 recurrent and encoder-decoder ones also on
    redrawn constant entries); qwen3-4b at full width and depth through the
    serve CLI, its decode held to fresh prefills and its int8 cache to the
    bf16 one; olmoe-1b-7b; rwkv6-1.6b, recurrentgemma-9b (twice, the second
    past its window) and whisper-small at full width and depth.  No kernel
    of the repo is on this path (the JAX package computes it in plain jnp);
    nothing falls back to the CPU."""
    import dataclasses
    import gc
    import time

    import torch

    from repro_torch.configs import ARCHS, get_config, get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import count_params, get_model, param_shapes

    t_phase = time.perf_counter()
    for name in ARCHS:
        redraws = (False, True) if get_reduced(name).family in REDRAWN_MAX_ABS else (False,)
        for redraw in redraws:
            r = lm_card_equals_cpu(dev, name, redraw)
            gates = (f"gate max|Δ| <= {r['limit']}" if redraw else
                     f"gate >= {LM_ARGMAX}, atol {LM_ATOL}, rtol {LM_RTOL}, max|Δ| <= "
                     f"{r['limit']}")
            print(f"[lm] card = CPU, {name} (reduced, B={LM_B}, S={LM_S}, prefill + "
                  f"{LM_STEPS} decode steps{', constant entries redrawn' if redraw else ''}): "
                  f"max|Δ| {r['max_abs']:.4g}, argmax agreement {r['agree']:.3f} ({gates}); "
                  f"card: {smi}")
            if not r["ok"]:
                raise SystemExit(f"[lm] {name}: the card leaves the CPU path: {r}")

    # ---- qwen3-4b, full width and depth, through the serve CLI ------------
    cfg = get_config("qwen3-4b")
    n_params = count_params(param_shapes(cfg))
    out = serve.main(list(QWEN_ARGS))
    if out["device"].split(":")[0] != "cuda":
        raise SystemExit(f"[lm] qwen3-4b served on {out['device']}")
    B, S, steps = out["batch"], out["prompt_len"], out["decode_steps"]
    bound = _lm_step_bytes(cfg, B, S + steps)
    bound_ms = bound["bound_ms"]
    print(f"[lm] qwen3-4b full width ({n_params:,} parameters, {cfg.n_layers} layers, "
          f"bf16 weights cast once at load): batch {B}, prompt {S}, {steps} decode steps; "
          f"prefill {out['prefill_ms']:.3f} ms, decode {out['decode_ms_median']:.3f} "
          f"ms/step (median after the first; first {out['decode_ms'][0]:.3f}), "
          f"{out['tok_per_s']:.1f} tok/s, peak memory_allocated {out['peak_bytes']:,} B; "
          f"decode bytes bound {bound_ms:.4f} ms ({bound['weights']:,} B of weights + "
          f"{bound['cache_read']:,} B of cache at the last step + {bound['gather']} B "
          f"gathered, at 3.35 TB/s), "
          f"decode/bound {out['decode_ms_median'] / bound_ms:.1f}x; card: {smi}")

    # decode at position S+i against a fresh prefill over S+i+1 tokens
    model = get_model(cfg, dev)
    params = model.init(serve.LM_SEED)  # the same weights as the CLI's
    dec, cache, agreement, max_abs, _ = _decode_vs_fresh(cfg, model, params, out, steps)
    same = float(np.abs(dec[0].cpu().numpy() - out["first_logits"][:, : cfg.vocab]).max())
    print(f"[lm] qwen3-4b decode at S+i vs a fresh prefill over S+i+1 tokens, i < {steps} "
          f"({B * steps} logit rows): argmax agreement {agreement:.4f} (gate >= {LM_ARGMAX}), "
          f"max|Δ| {max_abs:.4g} (gate <= {QWEN_DECODE_MAX_ABS}); the replayed first step "
          f"vs the CLI's: max|Δ| {same:.3g}; card: {smi}")
    if agreement < LM_ARGMAX or max_abs > QWEN_DECODE_MAX_ABS:
        raise SystemExit(f"[lm] qwen3-4b decode leaves prefill: agreement {agreement}, "
                         f"max|Δ| {max_abs}")

    toks = torch.from_numpy(out["tokens"]).to(dev)
    cache["length"] = S  # the steps rewrite the filled slots S..S+3
    prof = _profile(lambda i: model.decode_step(params, cache, toks[:, i]), 4)
    print(f"[lm] qwen3-4b decode under torch.profiler (4 steps at S..S+3, the "
          f"profiler's own cost included): {prof}; card: {smi}")

    # the int8 cache against the bf16 one, on the same weights and tokens
    prompt = torch.from_numpy(out["prompt"]).to(dev)
    model8 = get_model(dataclasses.replace(cfg, kv_cache_dtype="int8"), dev)
    logits, cache = model8.prefill(params, {"tokens": prompt}, max_seq=S + steps)
    agree8, rel8 = [], 0.0
    for i in range(steps):
        logits, cache = model8.decode_step(params, cache, toks[:, i])
        l8 = logits[:, : cfg.vocab].float()
        agree8.append((l8.argmax(-1) == dec[i].argmax(-1)).float().mean().item())
        rel8 = max(rel8, ((l8 - dec[i]).abs().max() / dec[i].abs().max()).item())
    print(f"[lm] qwen3-4b int8 cache vs bf16 over {steps} decode steps: argmax agreement "
          f"{np.mean(agree8):.4f} (gate >= {INT8_AGREE}), relative error {rel8:.4g} "
          f"(gate < {INT8_REL}); card: {smi}")
    if np.mean(agree8) < INT8_AGREE or not rel8 < INT8_REL:
        raise SystemExit(f"[lm] qwen3-4b int8 cache leaves bf16: agreement "
                         f"{np.mean(agree8)}, relative error {rel8}")
    del params, cache, dec, logits, model, model8
    gc.collect()
    torch.cuda.empty_cache()

    # ---- olmoe-1b-7b, full width and depth, through the serve CLI ----------
    ocfg = get_config("olmoe-1b-7b")
    oout = serve.main(list(OLMOE_ARGS))
    first = oout["first_logits"][:, : ocfg.vocab]
    drop = oout["moe_drop"]
    print(f"[lm] olmoe-1b-7b full width ({count_params(param_shapes(ocfg)):,} parameters, "
          f"{ocfg.n_layers} layers, {ocfg.n_experts} experts top-{ocfg.top_k}): batch "
          f"{oout['batch']}, prompt {oout['prompt_len']}, {oout['decode_steps']} steps; "
          f"prefill {oout['prefill_ms']:.3f} ms, decode {oout['decode_ms_median']:.3f} "
          f"ms/step, {oout['tok_per_s']:.1f} tok/s, peak memory_allocated "
          f"{oout['peak_bytes']:,} B; dropped routed slots {drop['prefill']:.4f} at "
          f"prefill, {drop['decode']:.4f} at decode; finite logits "
          f"{bool(np.isfinite(first).all())}; card: {smi}")
    if not np.isfinite(first).all() or oout["device"].split(":")[0] != "cuda":
        raise SystemExit("[lm] olmoe-1b-7b: non-finite logits or not on the card")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- slice 10: rwkv6, recurrentgemma, whisper at full width ------------
    slice10 = [slice10_full_width(dev, smi, argv, n_check, cuts)
               for argv, n_check, cuts in SLICE10_RUNS]
    phase_s = time.perf_counter() - t_phase
    print(f"[lm] phase {phase_s:.1f} s")
    return {"qwen": {k: out[k] for k in ("prefill_ms", "decode_ms_median", "tok_per_s",
                                         "peak_bytes")},
            "bound_ms": bound_ms, "agreement": agreement, "slice10": slice10,
            "phase_s": phase_s}


# ---- slice 11: LM training ----------------------------------------------------
LMT_B, LMT_S = 2, 32  # card = CPU on the reduced configs, test_torch_lm_train.py's
# tests/test_torch_lm_train.py's bounds (readings over six seeds there): the
# loss, each gradient leaf's relative L2, and one optimizer update on the
# same gradients (rtol 1e-6, atol 1e-7: float32 ulps of O(1) operands)
LMT_LOSS_ATOL = 0.01
LMT_GRAD_REL = {"rwkv": 0.16, "hybrid": 0.16}
LMT_GRAD_REL_DEFAULT = 0.08
LMT_OPT_RTOL, LMT_OPT_ATOL = 1e-6, 1e-7
# also run with grad_dtype="bf16": a transformer, and rwkv6, whose f32 entries
# then enter the forward in bf16
LMT_BF16 = ("qwen3-4b", "rwkv6-1.6b")
# rwkv6-1.6b at the JAX CLI's batch and sequence, whole: the largest LM whose
# masters, gradients and AdamW state (16 B a parameter) fit one 80 GB card.
# 10 steps, not the CLI's 50 (a cut of depth: 50 steps took 66.0 s on the
# card): the run stays inside its time with [lm-mesh] and [lm-mesh-train]
LMT_FULL = ("--arch", "rwkv6-1.6b", "--batch", "8", "--seq", "64", "--steps", "10")
LMT_RESUME = ("rwkv6-1.6b", 6, 2)  # reduced: (arch, steps, checkpoint every)


def _lm_train_batch(cfg, seed: int = 0) -> dict:
    """tests/test_torch_lm_train.py's batch: B=2, S=32, seeded tokens and
    labels, whisper's frames, a VLM's patch embeddings (their labels -1);
    CPU tensors."""
    import torch

    rng = np.random.default_rng(1000 + seed)
    batch, n_text = {}, LMT_S
    if cfg.family in ("encdec", "vlm"):
        side = rng.normal(size=(LMT_B, LMT_S // cfg.frontend_len_div, cfg.d_model))
        batch["frames" if cfg.family == "encdec" else "embeds"] = \
            torch.from_numpy(side.astype(np.float32)).to(torch.bfloat16)
        n_text = LMT_S - side.shape[1] if cfg.family == "vlm" else LMT_S
    batch["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, size=(LMT_B, n_text))
                                       .astype(np.int32))
    labels = rng.integers(0, cfg.vocab, size=(LMT_B, LMT_S)).astype(np.int32)
    if cfg.family == "vlm":
        labels[:, : LMT_S - n_text] = -1
    batch["labels"] = torch.from_numpy(labels)
    return batch


@contextlib.contextmanager
def moe_routes(routes: list | None):
    """Inside, the port's ``moe_route`` records each MoE layer's experts
    into ``routes`` (empty) or, given a filled list, takes them from it (a
    layer told apart by its router's first values, so a rematerialised
    call, or one on a router gathered anew on a mesh, finds its own),
    computing everything else as the port does.  Routing is discontinuous
    and its logits are bf16: a one-ulp difference in a token's input flips
    a near tie, so two devices are compared on one routing."""
    import torch

    import repro_torch.models.layers as Lyr

    real = Lyr.moe_route
    force = bool(routes)  # an empty list records
    seen = {}

    def route(x, w_router, *, top_k, capacity_factor, n_experts):
        key = tuple(w_router.reshape(-1)[:8].float().cpu().tolist())
        i = seen.setdefault(key, len(seen))
        if not force:
            out = real(x, w_router, top_k=top_k, capacity_factor=capacity_factor,
                       n_experts=n_experts)
            if i == len(routes):
                routes.append(out[0].cpu().numpy())
            return out
        B, S, D = x.shape
        N = B * S
        probs = torch.softmax(
            torch.einsum("nd,de->ne", x.reshape(N, D), w_router.to(x.dtype)).float(), dim=-1)
        top_e = torch.from_numpy(np.asarray(routes[i], np.int64)).to(x.device).reshape(N, top_k)
        top_p = torch.gather(probs, 1, top_e)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        flat_e = top_e.reshape(-1)
        cap = int(max(1, capacity_factor * top_k * N / n_experts))
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        starts = torch.searchsorted(sorted_e, torch.arange(n_experts + 1, device=x.device))
        rank_sorted = torch.arange(flat_e.numel(), device=x.device) - starts[sorted_e]
        rank = torch.empty_like(flat_e).scatter_(0, order, rank_sorted)
        return top_e, top_p, rank < cap, rank, cap

    Lyr.moe_route = route
    try:
        yield routes
    finally:
        Lyr.moe_route = real


def _train_step_grads(model, params, batch, routes):
    """One ``make_train_step``'s (loss, gradient tree), as it hands them to
    the optimizer, on ``params`` (left as they are)."""
    from repro_torch.train import make_train_step

    with moe_routes(routes):
        loss, grads = make_train_step(model, None).grads(params, batch)
    return float(loss), grads


def lm_train_card_equals_cpu(dev, name: str, grad_dtype: str = "f32") -> dict:
    """The reduced ``name`` with the same seeded float32 masters (``init``'s
    constant entries redrawn, so no gradient is trivially zero) and batch
    on the card and on the port's CPU path: one ``make_train_step``'s loss
    and gradients (an MoE config on the CPU's routes), then one optimizer
    update of each device's masters on the CPU's gradients.  Returns the
    readings and whether they hold ``tests/test_torch_lm_train.py``'s
    bounds."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import get_model
    from repro_torch.train import get_optimizer

    cfg = dataclasses.replace(get_reduced(name), grad_dtype=grad_dtype)
    cpu, card = get_model(cfg, "cpu"), get_model(cfg, dev)
    params = cpu.init(0, masters=True)
    _redraw_constants(params, 1)
    on_card = _to(params, dev)
    batch = _lm_train_batch(cfg)
    routes: list = []
    la, ga = _train_step_grads(cpu, params, batch, routes)
    lb, gb = _train_step_grads(card, on_card, {k: v.to(dev) for k, v in batch.items()},
                               routes)
    rel = 0.0
    for (path, a), (_, b) in zip(_named_paths(ga), _named_paths(gb)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise SystemExit(f"[lm-train] {name}: gradient {path} {a.dtype}{tuple(a.shape)} "
                             f"on the CPU, {b.dtype}{tuple(b.shape)} on the card")
        a, b = a.double(), b.double().cpu()
        if cfg.top_k == 1 and path.endswith("router"):  # p / p: rounding noise
            continue
        rel = max(rel, float(torch.linalg.norm(b - a) / torch.linalg.norm(a)))
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    step0 = torch.zeros((), dtype=torch.int32)
    opt.update(ga, opt.init(params), params, step0)
    opt.update(_to(ga, dev), opt.init(on_card), on_card, step0.to(dev))
    opt_err = 0.0
    for (path, a), (_, b) in zip(_named_paths(params), _named_paths(on_card)):
        b = b.cpu()
        excess = (b - a).abs() - (LMT_OPT_ATOL + LMT_OPT_RTOL * a.abs())
        opt_err = max(opt_err, float((b - a).abs().max()))
        if bool((excess > 0).any()):
            raise SystemExit(f"[lm-train] {name}: {cfg.optimizer} update of {path} on the "
                             f"card leaves the CPU's by {float((b - a).abs().max()):.3g}")
    bound = LMT_GRAD_REL.get(cfg.family, LMT_GRAD_REL_DEFAULT)
    ok = abs(la - lb) <= LMT_LOSS_ATOL and rel <= bound
    return {"name": name, "loss": la, "dloss": abs(la - lb), "rel": rel, "bound": bound,
            "opt_err": opt_err, "optimizer": cfg.optimizer, "moe_layers": len(routes),
            "ok": ok}


def _with_paths(fn, tree, path=""):
    """``tree``'s structure with ``fn(path, leaf)`` a leaf, the paths
    :func:`_named_paths` names."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, f"{path}.{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_with_paths(fn, v, f"{path}[{i}]") for i, v in enumerate(tree)]
    return fn(path, tree)


def _named_paths(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _named_paths(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_paths(v, f"{path}[{i}]")
    else:
        yield path, tree


def lm_train_phase(dev, smi: str) -> dict:
    """Slice 11 on the card: (a) the 10 reduced configs' training step on
    the card against the CPU path (loss, gradients, one optimizer update;
    ``grad_dtype="bf16"`` on one); (b) rwkv6-1.6b trained at full width and
    depth through ``python -m repro_torch.launch.train``'s ``main`` at the
    JAX CLI's batch and sequence (B=8, S=64, 10 AdamW steps), its loss decreasing,
    its step time, peak memory against the reckoned masters, gradients
    and state, and one step profiled; (c) a crash and resume on the card
    at the reduced rwkv6, ending on the parameters of the run without
    one.  No kernel of the repo is on this path."""
    import gc
    import tempfile
    import time

    import torch

    from repro_torch.configs import ARCHS, get_config, get_reduced
    from repro_torch.launch import train as train_cli
    from repro_torch.models import count_params, get_model, param_shapes
    from repro_torch.train import fit, get_optimizer, lm_batch_fn, make_train_step

    t_phase = time.perf_counter()
    for name, gd in [(n, "f32") for n in ARCHS] + [(n, "bf16") for n in LMT_BF16]:
        r = lm_train_card_equals_cpu(dev, name, gd)
        print(f"[lm-train] card = CPU, {name} (reduced, B={LMT_B}, S={LMT_S}, float32 "
              f"masters, grad_dtype {gd}{', the CPU routes on both' if r['moe_layers'] else ''}"
              f"): loss {r['loss']:.5f}, |Δloss| {r['dloss']:.3g} (gate <= {LMT_LOSS_ATOL}), "
              f"worst gradient leaf relative L2 {r['rel']:.3g} (gate <= {r['bound']}); one "
              f"{r['optimizer']} update on the CPU's gradients: max|Δ| {r['opt_err']:.3g} "
              f"(gate rtol {LMT_OPT_RTOL}, atol {LMT_OPT_ATOL}); card: {smi}")
        if not r["ok"]:
            raise SystemExit(f"[lm-train] {name}: the card leaves the CPU path: {r}")
    card_s = time.perf_counter() - t_phase

    # ---- (b) rwkv6-1.6b, full width and depth, through the training CLI ----
    cfg = get_config("rwkv6-1.6b")
    n_params = count_params(param_shapes(cfg))
    reckoned = 16 * n_params  # float32 masters, gradients, AdamW m and v
    t0 = time.perf_counter()
    out = train_cli.main(list(LMT_FULL) + ["--device", dev.type])
    full_s = time.perf_counter() - t0
    losses = out["losses"]
    finite = bool(np.isfinite(losses).all())
    print(f"[lm-train] rwkv6-1.6b full width ({n_params:,} parameters, {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}; nothing cut): batch 8, seq 64, {len(losses)} "
          f"AdamW steps in {full_s:.1f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f} (gate: "
          f"decreasing, all finite: {finite}); {out['ms_per_step']:.3f} ms/step (median "
          f"after the first; first {out['step_ms'][0]:.3f}, CUDA events); peak "
          f"memory_allocated {out['peak_bytes']:,} B against {reckoned:,} B reckoned for "
          f"masters, gradients, m and v (16 B a parameter), {out['peak_bytes'] / reckoned:.3f}x; "
          f"card: {smi}")
    if not finite or not losses[-1] < losses[0] or out["device"].split(":")[0] != "cuda":
        raise SystemExit(f"[lm-train] rwkv6-1.6b full width: losses {losses[0]} -> "
                         f"{losses[-1]}, finite {finite}, device {out['device']}")
    ms_per_step, peak = out["ms_per_step"], out["peak_bytes"]
    params = out.pop("params")
    model = get_model(cfg, dev)
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    state = opt.init(params)
    step = torch.tensor(len(losses), dtype=torch.int32, device=dev)
    batch_fn = lm_batch_fn(cfg, n_docs=1000, seq=64, batch=8, device=dev)
    train_step = make_train_step(model, opt)
    prof = _profile(lambda i: float(train_step(params, state, step, batch_fn(i))), 1)
    print(f"[lm-train] rwkv6-1.6b one training step under torch.profiler (forward, the "
          f"per-layer recompute, backward and the AdamW update; the profiler's own cost "
          f"included): {prof}; card: {smi}")
    ckpt_bytes = 12 * n_params
    print(f"[lm-train] rwkv6-1.6b full-width checkpoint (params, m, v in float32): "
          f"{ckpt_bytes:,} B before compression; its save time not measured")
    del params, state, model, train_step, out
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) crash and resume on the card ----------------------------------
    name, steps, every = LMT_RESUME
    rcfg = get_reduced(name)
    rmodel = get_model(rcfg, dev)
    rbatch = lm_batch_fn(rcfg, n_docs=100, seq=16, batch=2, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        p_full, l_full = fit(rmodel, rbatch, steps=steps)
        t0 = time.perf_counter()
        fit(rmodel, rbatch, steps=steps - every, ckpt_dir=tmp, ckpt_every=every)
        p_res, l_res = fit(rmodel, rbatch, steps=steps, ckpt_dir=tmp, ckpt_every=every)
        resume_s = time.perf_counter() - t0
        saved = sorted(os.listdir(tmp))
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_named_paths(p_full), _named_paths(p_res)))
    print(f"[lm-train] crash and resume on the card, {name} reduced: {steps} steps against "
          f"{steps - every} with a checkpoint every {every} ({saved}), then a restart to "
          f"{steps} ({resume_s:.2f} s both): parameters equal to the bit {same}, last losses "
          f"{l_full[-every:]} and {l_res}; card: {smi}")
    if not same or l_res != l_full[-every:]:
        raise SystemExit(f"[lm-train] {name}: the resumed run leaves the uninterrupted one")
    phase_s = time.perf_counter() - t_phase
    print(f"[lm-train] phase {phase_s:.1f} s (card = CPU {card_s:.1f} s, full width "
          f"{full_s:.1f} s)")
    return {"ms_per_step": ms_per_step, "peak_bytes": peak, "phase_s": phase_s}


# slice 12: the dry run's meta trace held against the card.  Steps that
# [lm] and [lm-train] run at full width: qwen3-4b's decode step (B=4, the
# serve CLI's 512-token prompt and 32 steps: a 544-slot cache) and a
# rwkv6-1.6b training step (B=8, S=64, the training CLI's defaults)
DRYRUN_CASES = (("qwen3-4b", dict(seq=544, batch=4, kind="decode")),
                ("rwkv6-1.6b", dict(seq=64, batch=8, kind="train")))
DRYRUN_DECODE_STEPS = 32  # the decode case's prompt is its cache less these
# (b): the caching allocator rounds a block up to 512 B, and a block of more
# than 1 MiB, carved from a segment rounded to 2 MiB, keeps the segment's
# rest when that is 1 MiB or less (it splits off no less): the most a
# tensor's block can exceed its bytes
def alloc_slack(nbytes: int) -> int:
    return 511 if nbytes <= 1 << 20 else 1 << 20


# (c): the card's peak over the meta trace's: 1.0002 (qwen3-4b decode) and
# 1.0012 (rwkv6-1.6b training) in the first run (PR 23), each under the
# allocator's slack; the band leaves room for blocks carved from other
# segments in a fuller run
DRYRUN_PEAK_BAND = (1.0, 1.01)
BF16_OPS_PER_S = 989e12  # the H100 SXM's dense bf16 tensor-core peak (data sheet)


def dryrun_place(dev, cfg, info: dict):
    """The step of ``info`` on the card, its arguments placed as the CLIs
    place them, not by ``launch.dryrun``: (step function, arguments).
    Training as ``launch/train.py`` (``train.loop.fit``): float32 masters
    from ``init(masters=True)``, ``opt.init``, the int32 step counter and
    ``lm_batch_fn``'s first batch.  Decoding as ``launch/serve.py``: the
    serving weights from ``init``, the cache that ``prefill`` of the
    CLI's prompt returns, and ``argmax``'s token; the position is set to
    the cache's last slot, where the meta trace decodes."""
    import torch

    from repro_torch.launch.serve import LM_SEED
    from repro_torch.models import get_model
    from repro_torch.train.loop import lm_batch_fn, make_train_step
    from repro_torch.train.optimizer import get_optimizer

    model = get_model(cfg, dev)
    B, S = info["batch"], info["seq"]
    if info["kind"] == "train":
        opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
        params = model.init(0, masters=True)
        state = opt.init(params)
        step = torch.tensor(0, dtype=torch.int32, device=dev)
        batch = lm_batch_fn(cfg, n_docs=1000, seq=S, batch=B, device=dev)(0)
        return make_train_step(model, opt), (params, state, step, batch)
    params = model.init(LM_SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED + 1)
    prompt = torch.randint(0, cfg.vocab, (B, S - DRYRUN_DECODE_STEPS), generator=gen,
                           device=dev)
    logits, cache = model.prefill(params, {"tokens": prompt}, max_seq=S)
    token = torch.argmax(logits[:, : cfg.vocab], -1)
    del logits, prompt
    cache["length"] = S - 1
    return model.decode_step, (params, cache, token)


def dryrun_check(dev, name: str, info: dict) -> dict:
    """One step of the dry run on the card: the same step traced on the
    meta device through ``launch.dryrun`` (a 1x1 mesh: per device = the
    whole step), then run on the card on arguments that the training or
    serving CLI's own path places there (``dryrun_place``).  (a)
    ``FlopCounterMode``'s count on the card equals the meta trace's; (b)
    ``memory_allocated`` grows by the dry run's argument bytes when those
    arguments are placed, within the allocator's rounding
    (``alloc_slack``): the dry run's argument list is the entry point's;
    (c) the card's ``max_memory_allocated`` over the step against the
    meta trace's peak live bytes, inside ``DRYRUN_PEAK_BAND``; (d) the
    step timed again, outside the counter, for achieved rates (readings,
    not gates)."""
    import gc
    import time

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.registry import _tensors
    from repro_torch.models.transformer import _masks

    cfg = get_config(name)
    mesh = make_test_mesh(1, 1)
    t0 = time.perf_counter()
    meta = dryrun.trace_lm(cfg, mesh, info)
    meta_s = time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()
    _masks(cfg, dev)  # made once and kept: not an argument of the step
    torch.ones(64, 64, device=dev) @ torch.ones(64, 64, device=dev)  # cuBLAS's workspace
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    fn, args = dryrun_place(dev, cfg, info)
    gc.collect()
    torch.cuda.synchronize(dev)
    placed = torch.cuda.memory_allocated(dev) - base
    n_args = len(list(_tensors(args)))
    slack = sum(alloc_slack(t.nbytes) for t in _tensors(args))
    pos = args[1]["length"] if info["kind"] == "decode" else None

    def run():
        if pos is not None:
            args[1]["length"] = pos  # decode writes the same slot each time
        return fn(*args)

    torch.cuda.reset_peak_memory_stats(dev)
    flops = FlopCounterMode(display=False)
    with flops:
        run()
    torch.cuda.synchronize(dev)
    card_peak = torch.cuda.max_memory_allocated(dev) - base
    card_flops = int(flops.get_total_flops())
    run()  # warm, then one timed step outside the counter
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    ratio = card_peak / meta["peak_live_bytes"]
    return {
        "name": name, "info": info, "meta_s": meta_s, "n_args": n_args,
        "meta_flops": meta["flops"], "card_flops": card_flops,
        "arg_bytes": meta["arg_bytes"], "placed": placed, "slack": slack,
        "meta_peak": meta["peak_live_bytes"], "card_peak": card_peak, "peak_ratio": ratio,
        "bytes_moved": meta["bytes_moved"], "ms": ms,
        "ok_flops": card_flops == meta["flops"],
        "ok_args": 0 <= placed - meta["arg_bytes"] <= slack,
        "ok_peak": DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1],
    }


# slice 15: a meshed prefill and a meshed training cell, rank 0 of a (2, 2)
# mesh of 4 gloo ranks on the one card against the meta trace on rank 0 of a
# 4-rank fake group: (name, layers (0: all), shape)
DRYRUN_MESH_CASES = (("qwen3-4b", 2, dict(seq=512, batch=4, kind="prefill")),
                     ("qwen3-4b", 2, dict(seq=64, batch=4, kind="train")))
# gloo all-gathers a CUDA tensor through a device buffer of its own as large as
# the gathered result (read in the same run: an all-gather of a 16 MiB bf16
# shard over 2 ranks, DRYRUN_STAGING_PROBE bytes); the meta trace counts the
# step's tensors, so the meshed cells' card peak may exceed the trace's by the
# largest gathered result times that buffer's share of it, and no more
DRYRUN_STAGING_PROBE = 16 << 20


def dryrun_mesh_rank(rank, device, cases) -> list:
    """One rank of :func:`dryrun_mesh_check`: each case's meshed step, its
    arguments placed through the port's meshed entry points (``init(mesh=)``
    weights or masters and the optimizer's state, the global batch), then
    run under the dry run's counters (``launch.dryrun.trace``: FLOPs and
    collectives) and again alone for ``max_memory_allocated``."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.launch.serve import LM_SEED
    from repro_torch.models import get_model
    from repro_torch.models.registry import _tensors
    from repro_torch.models.transformer import _masks
    from repro_torch.train.loop import lm_batch_fn, make_train_step
    from repro_torch.train.optimizer import get_optimizer

    mesh = RankMesh((2, 2), device_type=device.type)
    probe = torch.ones(DRYRUN_STAGING_PROBE // 2, dtype=torch.bfloat16, device=device)
    gathered = torch.empty((2,) + probe.shape, dtype=probe.dtype, device=device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    torch.distributed.all_gather(list(gathered.unbind(0)), probe, group=mesh.group("data"))
    torch.cuda.synchronize(device)
    staging = (torch.cuda.max_memory_allocated(device) - base) / gathered.nbytes
    del probe, gathered
    out = []
    for name, layers, info in cases:
        cfg = _depth(get_config(name), layers)
        model = get_model(cfg, device)
        B, S = info["batch"], info["seq"]
        _masks(cfg, device)
        torch.ones(64, 64, device=device) @ torch.ones(64, 64, device=device)
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        if info["kind"] == "train":
            opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
            params = model.init(0, masters=True, mesh=mesh)
            args = (params, opt.init(params), torch.tensor(0, dtype=torch.int32, device=device),
                    lm_batch_fn(cfg, 1000, S, B, device=device)(0))
            fn = make_train_step(model, opt, mesh)
            grad = torch.enable_grad
        else:
            gen = torch.Generator(device=device).manual_seed(LM_SEED + 1)
            args = (model.init(LM_SEED, mesh=mesh),
                    {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                             device=device)})
            fn = lambda p, b: model.prefill(p, b, S, mesh=mesh)  # noqa: E731
            grad = torch.no_grad
        gc.collect()
        torch.cuda.synchronize(device)
        placed = torch.cuda.memory_allocated(device) - base
        batch = args[-1]
        with grad():
            got = dryrun.trace(fn, *args, live=list(_tensors(args)))
            del got["out"]  # the step's outputs, not live in the run the peak reads
            gc.collect()
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            fn(*args)
            torch.cuda.synchronize(device)
        coll = {}
        for op, n in got["collectives"].items():
            kind = dryrun.COLLECTIVE_KINDS.get(op, op)
            coll[kind] = coll.get(kind, 0) + n
        out.append({"flops": got["flops"], "collectives": coll, "placed": placed,
                    "staging": staging,
                    "peak": torch.cuda.max_memory_allocated(device) - base,
                    "batch_bytes": sum(t.nbytes for t in batch.values()),
                    "slack": sum(alloc_slack(t.nbytes) for t in _tensors(args))})
        del args, fn, batch, got
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dryrun_mesh_check(dev, smi: str) -> None:
    """:data:`DRYRUN_MESH_CASES`: rank 0's counts on the card against the
    meta trace's (``launch.dryrun.trace_meshed``): (a) FLOPs and (e) the
    collectives' bytes by kind equal; (b) ``memory_allocated`` grows by the
    trace's argument bytes, the batch whole (every rank takes the global
    batch; the dry run's per-device bytes count its data shard), within
    the allocator's rounding; (c) the peak at least the trace's and above
    it by no more than gloo's staging of the largest gathered result
    (``DRYRUN_STAGING_PROBE``)."""
    from repro_torch.configs import get_config
    from repro_torch.gbdt.distributed import run_ranks
    from repro_torch.launch import dryrun
    from repro_torch.launch.input_specs import _dp
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(2, 2)
    metas = [dryrun.trace_meshed(_depth(get_config(n), layers), ("data", "model"), (2, 2), info)
             for n, layers, info in DRYRUN_MESH_CASES]
    card = run_ranks(dryrun_mesh_rank, LM_MESH_RANKS, DRYRUN_MESH_CASES, device=dev)[0]
    for (name, layers, info), meta, r in zip(DRYRUN_MESH_CASES, metas, card):
        shard = r["batch_bytes"] // mesh.shape["data"] if _dp(mesh, info["batch"]) else \
            r["batch_bytes"]
        want_args = meta["arg_bytes"] - shard + r["batch_bytes"]
        ratio = r["peak"] / meta["peak_live_bytes"]
        size = {"torch.float32": 4, "torch.bfloat16": 2}
        largest = 2 * max(np.prod(shp) * size[dt] for kind, dt, shp in meta["collective_log"]
                          if kind == "all-gather")  # every group of a (2, 2) mesh: 2 ranks
        excess = r["peak"] - meta["peak_live_bytes"]
        ok = (r["flops"] == meta["flops"] and r["collectives"] == {
            k: v for k, v in meta["collectives"].items() if k != "total"}
              and 0 <= r["placed"] - want_args <= r["slack"]
              and 0 <= excess <= r["staging"] * largest)
        what = f"cut to {layers} layers" if layers else "full depth"
        print(f"[dryrun] {name} {info['kind']} meshed on (2, 2) (B={info['batch']}, "
              f"S={info['seq']}, full width, {what}), rank 0 of {LM_MESH_RANKS} gloo ranks "
              f"on the card against rank 0 of a fake group on meta: (a) FLOPs meta "
              f"{meta['flops']:,} card {r['flops']:,}; (e) collectives by kind meta "
              f"{meta['collectives']} card {r['collectives']}; (b) argument bytes "
              f"{meta['arg_bytes']:,} (+{r['batch_bytes'] - shard:,} the global batch), "
              f"memory_allocated grew {r['placed']:,}; (c) peak meta "
              f"{meta['peak_live_bytes']:,} card {r['peak']:,}, {ratio:.4f}x, {excess:,} B "
              f"over (gate: 0 to gloo's staging, {r['staging']:.3f}x of a gathered result, of "
              f"the largest, {int(largest):,} B); card: {smi}")
        if not ok:
            raise SystemExit(f"[dryrun] {name} {info['kind']} meshed: the meta trace leaves "
                             f"the card")


def dryrun_phase(dev, smi: str) -> None:
    """Slice 12 on the card: each of ``DRYRUN_CASES`` through
    :func:`dryrun_check`; fails unless (a), (b) and (c) hold; then slice
    15's :data:`DRYRUN_MESH_CASES` (:func:`dryrun_mesh_check`)."""
    import time

    t0 = time.perf_counter()
    for name, info in DRYRUN_CASES:
        r = dryrun_check(dev, name, info)
        tflops = r["card_flops"] / r["ms"] / 1e9
        gbs = r["bytes_moved"] / r["ms"] / 1e6
        print(f"[dryrun] {name} {info['kind']} (B={info['batch']}, S={info['seq']}, full "
              f"width; meta trace {r['meta_s']:.1f} s): (a) FLOPs meta {r['meta_flops']:,} "
              f"card {r['card_flops']:,} (gate: equal); (b) argument bytes {r['arg_bytes']:,}, "
              f"memory_allocated grew {r['placed']:,} for {r['n_args']} tensors, "
              f"{r['placed'] - r['arg_bytes']:,} B over (gate: 0 to the allocator's rounding, "
              f"{r['slack']:,} B); (c) peak live bytes meta {r['meta_peak']:,}, "
              f"card max_memory_allocated {r['card_peak']:,}, {r['peak_ratio']:.4f}x (gate: "
              f"{DRYRUN_PEAK_BAND[0]}-{DRYRUN_PEAK_BAND[1]}x); (d) {r['ms']:.3f} ms a step "
              f"(CUDA events), {tflops:.3f} TFLOP/s counted = {100 * tflops * 1e12 / BF16_OPS_PER_S:.2f} "
              f"% of 989 TFLOP/s bf16 ({100 * tflops * 1e12 / FP32_OPS_PER_S:.1f} % of 67 fp32), "
              f"{gbs:.1f} GB/s moved (each operator's inputs and outputs) = "
              f"{100 * gbs * 1e9 / HBM_BYTES_PER_S:.2f} % of 3.35 TB/s; card: {smi}")
        if not (r["ok_flops"] and r["ok_args"] and r["ok_peak"]):
            raise SystemExit(f"[dryrun] {name}: the meta trace leaves the card: {r}")
    dryrun_mesh_check(dev, smi)
    print(f"[dryrun] phase {time.perf_counter() - t0:.1f} s")


# ---- slices 13-14: LM serving on a (data, model) mesh ---------------------
LM_MESH_RANKS = 4  # gloo ranks on the one card (NCCL puts no two ranks on one device)
# qwen3-4b at full width on (1, 4): (mesh, batch, prompt, cache slots, decode
# steps); the cache's 544 slots are 136 a rank
LM_MESH_QWEN = ((1, 4), 4, 512, 544, 4)
# reduced olmoe-1b-7b on (2, 2), on the CPU and on the card in the same ranks
LM_MESH_OLMOE = ((2, 2), 4, 32, 40, 3)
# qwen3-4b (1, 4) against the unmeshed path on the card, teacher-forced:
# (argmax agreement >=, max|Δ| <=).  Predicted before the first card run
# from the CPU, where the reduced config's (1, 4) logits leave the unmeshed
# ones by 0 to 0.0195: on the card the row-parallel products sum four
# float32 partials where cuBLAS accumulates one bf16 product, an ulp
# apart, which 36 random-weight layers grow (predicted 0.03-0.15, gate
# 0.25).  Read on an NVIDIA H100 80GB HBM3 at 700 W: max|Δ| 0.09766 and
# agreement 1.0 in two runs (PERF.md §6, PR 24); the gate keeps room over it
LM_MESH_QWEN_GATE = (LM_ARGMAX, 0.125)
# slice 14: rwkv6, the RG-LRU hybrid and whisper at full width on (1, 4)
# against one card, fed the one-card run's greedy tokens: {label: (arch,
# layers (0: all), mesh, batch, prompt, cache slots, decode steps, encoder
# frames, (argmax agreement >=, max|Δ| <=))}.  Predicted before the first
# card run at LM_ARGMAX and <= 1.0 (rwkv6, its served-gap limit), <= 0.125
# (the others); read on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6):
# whisper-small 0.005859 (hit); recurrentgemma-9b 0.2031, argmax 1.0
# (missed), so it takes its family's served-gap limit, QWEN_DECODE_MAX_ABS
# (SLICE10_DECODE["hybrid"]: decode vs fresh prefill read 0.2227-0.2305);
# rwkv6-1.6b 1.199 and argmax 0.5 (missed).  RWKV-6 on random weights
# grows the product rounding the mesh changes (float32 partial sums over
# "model", cuBLAS's kernel for a column block) layer by layer: its
# prefill's residual stream leaves the one card's by 1 bf16 ulp after
# layer 0 (relative norm 0.00047) and by 0.238 of its norm after layer 23,
# so its full depth is gated at a band around that reading (a fault in the
# head or block mapping sends the argmax to chance among 65,536), and the
# same model cut to 2 layers at full width, where the rounding has not
# grown (read 0.041, argmax 1.0), at LM_MESH_QWEN_GATE.  recurrentgemma-9b
# at B=1 and 2 steps: 38 layers of ~5 ms gloo collectives a step.
LM_MESH_FULL = {
    "rwkv6-1.6b": ("rwkv6-1.6b", 0, (1, 4), 4, 128, 132, 4, 0, (0.25, 2.0)),
    "rwkv6-1.6b, 2 layers": ("rwkv6-1.6b", 2, (1, 4), 4, 128, 132, 4, 0, LM_MESH_QWEN_GATE),
    "whisper-small": ("whisper-small", 0, (1, 4), 4, 64, 68, 4, 256, LM_MESH_QWEN_GATE),
    "recurrentgemma-9b": ("recurrentgemma-9b", 0, (1, 4), 1, 64, 68, 2, 0,
                          (LM_ARGMAX, QWEN_DECODE_MAX_ABS)),
}
# the reduced configs on (2, 2), each rank on the card against the same rank
# on the CPU: (mesh, batch, prompt, decode steps, batch split over "data").
# rwkv6 at one row whole on every rank (dp=None: long_500k's form); the
# hybrid's 16-token prompt fills its 16-slot window, so its steps wrap the
# ring.  Gate: the reduced transformer configs' card = CPU reading
# (LM_MESH_CARD_CPU, PERF.md), or the family's own card = CPU reading on
# the same weights and inputs without a mesh, read in the same run, where
# that is larger (the hybrid's read 0.03906 and 0.01563-0.01758 over three
# prompts; the mesh's 0.03906 and 0)
# C1 (ROADMAP §C): rwkv6-1.6b's full-depth gap on the mesh is rounding.  On the card (NVIDIA
# H100 80GB HBM3, 700 W; tools/lm_mesh_rounding.py, PERF.md §6): with every
# bf16 product in float32 (f32_products) it stays at 1.309 (argmax 0.4); with
# the one card's products split into the mesh's blocks (blocks_matched: the
# ranks' kernels) the prefill's last-token residual after layers 0 and 1 is
# the mesh's to the bit and the logits read 0.844 (argmax 0.75); and one card
# against itself, the same products with only the order of each row-parallel
# product's 4 float32 partials reversed (no mesh at all), reads 0.844 (argmax
# 0.70): random-weight RWKV-6 grows a float32 ulp in a sum to that gap over 24
# layers.  So beside the band, each of these mesh runs is held against one
# card in the mesh's blocks, teacher-forced on the same tokens: full depth
# within LM_MESH_C1_SPREAD times that one card's own spread under the reversed
# sum order, read in the same run (a mapping fault leaves it far behind), and
# 2 layers tight at (LM_ARGMAX, 0.0625) (read 0.03125 and 1.0)
LM_MESH_C1_SPREAD = 1.25
LM_MESH_C1 = {"rwkv6-1.6b": None, "rwkv6-1.6b, 2 layers": (LM_ARGMAX, 0.0625)}
LM_MESH_REDUCED = {
    "rwkv6-1.6b": ((2, 2), 1, 32, 3, False),
    "recurrentgemma-9b": ((2, 2), 4, 16, 4, True),
    "whisper-small": ((2, 2), 4, 32, 3, True),
}
LM_MESH_CARD_CPU = 0.0234375


def _dp(split: bool):
    """The ``dp`` argument: the mesh's data axes, or None (the batch whole)."""
    from repro_torch.models.base import MESH_DP

    return MESH_DP if split else None


def _mesh_serve(cfg, params, batch, forced, max_seq, mesh, dev, split: bool = True) -> dict:
    """Prefill and teacher-forced decode steps on ``mesh`` (this rank's
    shards; None: one device) through ``get_model``: the rank's logits (float32 host arrays,
    one a step), host ms of the prefill and of each step (synchronised on
    the card), and the MoE stats (this rank's experts' kept slots, the
    shard's routed slots).  ``split``: the batch over ``"data"`` (else whole
    on every rank, ``dp=None``)."""
    import time

    import torch

    from repro_torch.models import get_model

    model = get_model(cfg, dev)
    kw = {} if mesh is None else {"mesh": mesh, "dp": _dp(split)}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    stats = {}
    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {k: t.to(dev) for k, t in batch.items()}, max_seq,
                                  stats, **kw)
    sync()
    out = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "step_ms": [],
           "logits": [logits.float().cpu().numpy()]}
    for tok in forced:
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok.to(dev), stats, **kw)
        sync()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["logits"].append(logits.float().cpu().numpy())
    out["stats"] = {k: int(v) for k, v in stats.items()}
    return out


def _mesh_card_and_cpu(name: str, shape, inputs, max_seq: int, device,
                       split: bool = True) -> dict:
    """This rank's part of the reduced ``name`` on a ``shape`` mesh, on the
    CPU and on the card, on the same CPU-drawn weights (``init`` seed 0,
    this rank's shards) and teacher-forced tokens."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import get_model

    mesh = RankMesh(shape, device_type="cuda")
    cfg = get_reduced(name)
    params = get_model(cfg, "cpu").init(0, mesh=mesh)
    return {"coords": mesh.coords,
            "cpu": _mesh_serve(cfg, params, *inputs, max_seq, mesh, torch.device("cpu"),
                               split),
            "card": _mesh_serve(cfg, _to(params, device), *inputs, max_seq, mesh, device,
                                split)}


def _full_width_mesh(name: str, shape, max_seq: int, inputs, device, layers: int = 0) -> dict:
    """``name`` at full width and depth (``layers`` of them, when given) on
    a ``shape`` mesh: ``init``'s seeded weights (this rank's shards, drawn
    on the card), served through :func:`_mesh_serve`, with the rank's shard
    bytes and its peak ``memory_allocated``; the shards are freed after."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.launch.serve import LM_SEED
    from repro_torch.models import get_model
    from repro_torch.models.registry import _tensors

    mesh = RankMesh(shape, device_type="cuda")
    cfg = _depth(get_config(name), layers)
    params = get_model(cfg, device).init(LM_SEED, mesh=mesh)
    shard_bytes = sum(t.nbytes for t in _tensors(params))
    torch.cuda.reset_peak_memory_stats(device)
    out = _mesh_serve(cfg, params, *inputs, max_seq, mesh, device)
    out.update(shard_bytes=shard_bytes, peak=torch.cuda.max_memory_allocated(device))
    del params
    torch.cuda.empty_cache()
    return out


def lm_mesh_rank(rank, device, qwen_in, olmoe_in, full_in, reduced_in) -> dict:
    """One rank of ``[lm-mesh]``: qwen3-4b at full width on a (1, 4) mesh,
    the reduced olmoe-1b-7b on (2, 2) on the CPU and on the card
    (:func:`_mesh_card_and_cpu`), then slice 14: rwkv6-1.6b (also cut to 2
    layers), whisper-small and recurrentgemma-9b at full width on (1, 4)
    (:data:`LM_MESH_FULL`) and the three reduced on (2, 2) on the CPU and
    the card (:data:`LM_MESH_REDUCED`)."""
    import torch

    out = {}
    with torch.no_grad():
        shape, _, _, max_seq, _ = LM_MESH_QWEN
        out["qwen"] = _full_width_mesh("qwen3-4b", shape, max_seq, qwen_in, device)
        shape, _, _, max_seq, _ = LM_MESH_OLMOE
        out["olmoe"] = _mesh_card_and_cpu("olmoe-1b-7b", shape, olmoe_in, max_seq, device)
        for label, inputs in full_in.items():
            name, layers, shape, _, _, max_seq, *_ = LM_MESH_FULL[label]
            out[label] = _full_width_mesh(name, shape, max_seq, inputs, device, layers)
        for name, inputs in reduced_in.items():
            shape, _, S, steps, split = LM_MESH_REDUCED[name]
            out["reduced", name] = _mesh_card_and_cpu(name, shape, inputs, S + steps + 5,
                                                      device, split)
    return out


def lm_mesh_card_rank(rank, device, name, shape, inputs, max_seq, split=True) -> dict:
    """One rank of :func:`lm_mesh_card_equals_cpu`."""
    import torch

    with torch.no_grad():
        return _mesh_card_and_cpu(name, shape, inputs, max_seq, device, split)


def mesh_inputs(name: str, B: int, S: int, steps: int, seed: int = 24):
    """A seeded batch (the prompt (B, S); an encoder-decoder's frames (B, S
    / frontend_len_div, D) bf16 too) and ``steps`` teacher-forced tokens
    (B,), for the reduced ``name``."""
    import torch

    from repro_torch.configs import get_reduced

    cfg = get_reduced(name)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    forced = [torch.from_numpy(rng.integers(0, cfg.vocab, (B,))) for _ in range(steps)]
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, S // cfg.frontend_len_div, cfg.d_model))
        batch["frames"] = torch.from_numpy(frames.astype(np.float32)).to(torch.bfloat16)
    return batch, forced


def mesh_card_vs_cpu(name: str, ranks: list, limit: float = LM_CARD_MAX_ABS) -> dict:
    """The card's ranks against the same ranks on the CPU (each rank's
    ``{"coords", "cpu", "card"}``): max|Δ| over every logit row, each data
    shard's kept MoE slots (CPU, card, routed), and whether every rank's
    kept count is equal and max|Δ| within ``limit``."""
    from repro_torch.configs import get_reduced

    vocab = get_reduced(name).vocab
    worst, equal, shards = 0.0, True, {}
    for r in ranks:
        for a, b in zip(r["cpu"]["logits"], r["card"]["logits"]):
            worst = max(worst, float(np.abs(a[:, :vocab] - b[:, :vocab]).max()))
        cpu_st, card_st = r["cpu"]["stats"], r["card"]["stats"]
        equal &= cpu_st == card_st
        if cpu_st:
            k = shards.setdefault(r["coords"]["data"], [0, 0, cpu_st["slots"]])
            k[0] += cpu_st["kept"]
            k[1] += card_st["kept"]
    return {"max_abs": worst, "kept": shards, "kept_equal": equal, "limit": limit,
            "ok": worst <= limit and equal}


def one_device_card_vs_cpu(dev, name: str, inputs, max_seq: int) -> float:
    """max|Δ| of the reduced ``name``'s logits on the card against the CPU
    with no mesh, on ``init`` seed 0's weights and ``inputs``: the family's
    own card = CPU reading on the inputs a meshed run is held to."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import get_model

    cfg = get_reduced(name)
    params = get_model(cfg, "cpu").init(0)
    with torch.no_grad():
        cpu, card = (_mesh_serve(cfg, _to(params, d), *inputs, max_seq, None, d)["logits"]
                     for d in (torch.device("cpu"), dev))
    return max(float(np.abs(a[:, :cfg.vocab] - b[:, :cfg.vocab]).max())
               for a, b in zip(cpu, card))


def lm_mesh_card_equals_cpu(dev, name: str, shape, B: int = 4, S: int = 32,
                            steps: int = 3, split: bool = True,
                            limit: float | None = LM_CARD_MAX_ABS) -> dict:
    """The reduced ``name`` on a ``shape`` mesh of ``LM_MESH_RANKS`` gloo
    ranks sharing the card, each rank on the card and on the CPU
    (:func:`mesh_card_vs_cpu`); ``split``: the batch over ``"data"`` (else
    whole on every rank).  ``limit=None``: ``LM_MESH_CARD_CPU``, or the
    family's one-device card = CPU reading on the same weights and inputs
    where that is larger (:func:`one_device_card_vs_cpu`, returned as
    ``"one_device"``)."""
    from repro_torch.gbdt.distributed import run_ranks

    inputs = mesh_inputs(name, B, S, steps)
    one = None
    if limit is None:
        one = one_device_card_vs_cpu(dev, name, inputs, S + steps + 5)
        limit = max(LM_MESH_CARD_CPU, one)
    ranks = run_ranks(lm_mesh_card_rank, LM_MESH_RANKS, name, shape, inputs, S + steps + 5,
                      split, device=dev)
    return {**mesh_card_vs_cpu(name, ranks, limit), "one_device": one}


def _depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers (0: as it is)."""
    import dataclasses

    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _one_card(dev, name: str, B: int, S: int, max_seq: int, steps: int, frames: int = 0,
              layers: int = 0, forced=None, matched: int = 0, reverse: bool = False):
    """``name`` at full width and depth (``layers`` of them, when given) on
    one card from ``init``'s seeded weights: a seeded prompt (and
    ``frames`` encoder frames), prefill and ``steps`` greedy decode steps
    (the tokens ``forced``, when given) timed with CUDA events, with the
    products split as a mesh of ``matched`` ranks on ``"model"`` splits
    them (:func:`blocks_matched`, its partial sums in ``reverse`` order
    with ``reverse``) when ``matched``.  Returns the run
    ({prefill_ms, step_ms, logits}), the batch and the decoded tokens (on
    the host), and frees the card."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import LM_SEED
    from repro_torch.models import get_model

    cfg = _depth(get_config(name), layers)
    model = get_model(cfg, dev)
    gen = torch.Generator().manual_seed(LM_SEED + 2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen)}
    if frames:
        batch["frames"] = torch.randn((B, frames, cfg.d_model), generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        params = model.init(LM_SEED)
        mode = (blocks_matched(cfg, params, matched, reverse) if matched
                else contextlib.nullcontext())
        with mode:
            one, decoded = _timed_decode(model, params, batch, max_seq, steps, forced, dev)
    del params, model, mode
    gc.collect()
    torch.cuda.empty_cache()
    return one, batch, decoded


def _timed_decode(model, params, batch, max_seq: int, steps: int, forced, dev):
    """:func:`_one_card`'s prefill and decode steps: ({prefill_ms, step_ms,
    logits}, the decoded tokens on the host)."""
    import torch

    cfg = model.cfg
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    logits, cache = model.prefill(params, {k: t.to(dev) for k, t in batch.items()},
                                  max_seq=max_seq)
    end.record()
    end.synchronize()
    one = {"prefill_ms": start.elapsed_time(end), "step_ms": [],
           "logits": [logits.float().cpu().numpy()]}
    decoded = []
    for i in range(steps):
        tok = (forced[i].to(dev) if forced is not None
               else torch.argmax(logits[:, : cfg.vocab], -1))
        decoded.append(tok.cpu())
        start.record()
        logits, cache = model.decode_step(params, cache, tok)
        end.record()
        end.synchronize()
        one["step_ms"].append(start.elapsed_time(end))
        one["logits"].append(logits.float().cpu().numpy())
    return one, decoded


def _meshed_vs_one_card(name: str, shape, B: int, S: int, steps: int, gate, one: dict,
                        ranks: list, smi: str, what: str = "") -> None:
    """Print the full-width ``name``'s (1, n) mesh run against its one-card
    run and fail unless every rank's logits are equal and within ``gate``
    (argmax agreement >=, max|Δ| <=) of the one card's."""
    from repro_torch.configs import get_config

    vocab = get_config(name).vocab
    want = np.concatenate([a[:, :vocab] for a in one["logits"]])
    got = [np.concatenate([a[:, :vocab] for a in r["logits"]]) for r in ranks]
    same = all(np.array_equal(g, got[0]) for g in got)
    max_abs = float(np.abs(got[0] - want).max())
    agree = float(np.mean(got[0].argmax(-1) == want.argmax(-1)))
    per_step = [float(np.abs(a[:, :vocab] - b[:, :vocab]).max())
                for a, b in zip(ranks[0]["logits"], one["logits"])]
    prefill_ms = max(r["prefill_ms"] for r in ranks)
    step_ms = [max(r["step_ms"][i] for r in ranks) for i in range(steps)]
    print(f"[lm-mesh] {name} full width on a {shape} mesh of {LM_MESH_RANKS} gloo ranks on "
          f"one card (B={B}, prompt {S}{what}, {steps} teacher-forced decode steps): weight "
          f"shards {ranks[0]['shard_bytes']:,} B a rank, peak memory_allocated a rank "
          f"{max(r['peak'] for r in ranks):,} B; logits vs the one-card path: max|Δ| "
          f"{max_abs:.4g} (gate <= {gate[1]}), argmax agreement {agree:.4f} "
          f"(gate >= {gate[0]}), max|Δ| a step (prefill first) "
          f"{', '.join(f'{d:.4g}' for d in per_step)}, equal on every rank: {same}; prefill "
          f"{prefill_ms:.1f} ms meshed (slowest rank, host clock) vs {one['prefill_ms']:.1f} "
          f"ms on one card; decode ms a step meshed "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} vs one card "
          f"{', '.join(f'{t:.1f}' for t in one['step_ms'])}; card: {smi}")
    if not same or max_abs > gate[1] or agree < gate[0]:
        raise SystemExit(f"[lm-mesh] {name} on the mesh leaves the one-card path: "
                         f"max|Δ| {max_abs}, agreement {agree}, ranks equal {same}")


def lm_mesh_phase(dev, smi: str) -> dict:
    """Slices 13-14 on the card, in one world of ``LM_MESH_RANKS`` gloo
    ranks sharing the card (every rank computes on it; gloo moves the
    collectives' CUDA tensors through host memory itself): qwen3-4b,
    rwkv6-1.6b (also cut to 2 layers), whisper-small and recurrentgemma-9b
    at full width on one card, then on a (1, 4) mesh, fed the one-card
    run's greedy tokens, the logits held to ``LM_MESH_QWEN_GATE`` (slice
    14's to their ``LM_MESH_FULL`` gates); the reduced olmoe-1b-7b on
    (2, 2), the card's ranks against the same ranks on the CPU (logits
    within ``LM_CARD_MAX_ABS``, each rank's kept MoE slots equal), and the
    reduced rwkv6 (one row, whole on every rank), recurrentgemma and
    whisper on (2, 2) the same way, within ``LM_MESH_CARD_CPU`` or the
    family's one-device card = CPU reading on the same inputs where that is
    larger.  C1 (:data:`LM_MESH_C1`): rwkv6-1.6b's mesh runs also against
    one card with its products in the mesh's blocks (``blocks_matched``),
    teacher-forced on the same tokens.  A failed rank stops the phase with
    its traceback."""
    import time

    from repro_torch.configs import get_config
    from repro_torch.gbdt.distributed import run_ranks

    t_phase = time.perf_counter()
    shape, B, S, max_seq, steps = LM_MESH_QWEN
    one, prompt, forced = _one_card(dev, "qwen3-4b", B, S, max_seq, steps)
    ones, full_in = {}, {}
    for label, (name, layers, _, fB, fS, fmax, fsteps, frames, _) in LM_MESH_FULL.items():
        ones[label], batch, ftoks = _one_card(dev, name, fB, fS, fmax, fsteps, frames, layers)
        full_in[label] = (batch, ftoks)
    matched = {}  # C1: one card in the mesh's product blocks, forward and reversed sums
    for label in LM_MESH_C1:
        name, layers, fshape, fB, fS, fmax, fsteps, frames, _ = LM_MESH_FULL[label]
        matched[label] = [_one_card(dev, name, fB, fS, fmax, fsteps, frames, layers,
                                    forced=full_in[label][1], matched=fshape[1],
                                    reverse=rev)[0] for rev in (False, True)]
    oshape, oB, oS, _, osteps = LM_MESH_OLMOE
    olmoe_in = mesh_inputs("olmoe-1b-7b", oB, oS, osteps)
    reduced_in = {name: mesh_inputs(name, rB, rS, rsteps)
                  for name, (_, rB, rS, rsteps, _) in LM_MESH_REDUCED.items()}
    one_device = {name: one_device_card_vs_cpu(dev, name, reduced_in[name], rS + rsteps + 5)
                  for name, (_, _, rS, rsteps, _) in LM_MESH_REDUCED.items()}
    one_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    ranks = run_ranks(lm_mesh_rank, LM_MESH_RANKS, (prompt, forced), olmoe_in, full_in,
                      reduced_in, device=dev)
    ranks_s = time.perf_counter() - t0

    # qwen3-4b: every rank holds all rows (data 1) and the gathered vocabulary
    _meshed_vs_one_card("qwen3-4b", shape, B, S, steps, LM_MESH_QWEN_GATE, one,
                        [r["qwen"] for r in ranks], smi, f", {max_seq}-slot cache = "
                        f"{max_seq // shape[1]} a rank")
    # olmoe-1b-7b (2, 2): each rank's card run against its CPU run
    o = mesh_card_vs_cpu("olmoe-1b-7b", [r["olmoe"] for r in ranks])
    print(f"[lm-mesh] olmoe-1b-7b reduced on a {oshape} mesh (B={oB}, prompt {oS}, {osteps} "
          f"teacher-forced steps), the card's ranks vs the same ranks on the CPU: max|Δ| "
          f"{o['max_abs']:.4g} (gate <= {LM_CARD_MAX_ABS}); kept MoE slots a data shard (CPU, "
          f"card, routed) {o['kept']}, equal on every rank: {o['kept_equal']}; card: {smi}")
    if not o["ok"]:
        raise SystemExit(f"[lm-mesh] olmoe-1b-7b on the card's mesh leaves the CPU's: {o}")
    # slice 14 at full width: each against its one-card run
    for label, (name, layers, fshape, fB, fS, _, fsteps, frames, gate) in LM_MESH_FULL.items():
        what = (f", {frames} encoder frames" if frames else "") + (
            f", cut to {layers} layers" if layers else "")
        _meshed_vs_one_card(name, fshape, fB, fS, fsteps, gate, ones[label],
                            [r[label] for r in ranks], smi, what)
        if label in matched:
            fwd, rev = matched[label]
            vocab = get_config(name).vocab
            spread = max(float(np.abs(a[:, :vocab] - b[:, :vocab]).max())
                         for a, b in zip(fwd["logits"], rev["logits"]))
            c1 = LM_MESH_C1[label] or (0.25, LM_MESH_C1_SPREAD * spread)
            print(f"[lm-mesh] C1: {label}, one card with its products in the mesh's "
                  f"{fshape[1]} blocks against itself with each row-parallel product's "
                  f"float32 partials summed in reverse: max|Δ| {spread:.4g} (no mesh)")
            _meshed_vs_one_card(name, fshape, fB, fS, fsteps, c1, fwd,
                                [r[label] for r in ranks], smi,
                                what + ", one card in the mesh's product blocks")
    # slice 14 reduced on (2, 2): each rank's card run against its CPU run
    for name, (rshape, rB, rS, rsteps, split) in LM_MESH_REDUCED.items():
        runs = [r["reduced", name] for r in ranks]
        o = mesh_card_vs_cpu(name, runs, max(LM_MESH_CARD_CPU, one_device[name]))
        card = [r["card"] for r in runs]
        step_ms = [max(c["step_ms"][i] for c in card) for i in range(rsteps)]
        split_s = "the batch over data" if split else "dp=None: the row whole on every rank"
        print(f"[lm-mesh] {name} reduced on a {rshape} mesh (B={rB}, {split_s}, prompt {rS}, "
              f"{rsteps} teacher-forced steps), the card's ranks vs the same ranks on the CPU: "
              f"max|Δ| {o['max_abs']:.4g} (gate <= {o['limit']:.4g}: {LM_MESH_CARD_CPU} or "
              f"the one-device card = CPU reading {one_device[name]:.4g}); card prefill "
              f"{max(c['prefill_ms'] for c in card):.1f} ms, decode ms a step "
              f"{', '.join(f'{t:.1f}' for t in step_ms)} (slowest rank, host clock); "
              f"card: {smi}")
        if not o["ok"]:
            raise SystemExit(f"[lm-mesh] {name} on the card's mesh leaves the CPU's: {o}")
    print(f"[lm-mesh] one-card runs {one_s:.1f} s, ranks {ranks_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"ranks_s": ranks_s}


# ---- slices 15-16: LM training on a (data, model) mesh --------------------
# Full width on (2, 2): 4 gloo ranks on the one card, FSDP over "data" and
# tensor parallel over "model", each against one card's steps on the same
# weights and batches.  The one-card reference steps run first and free the
# card (their gradients go to files, a leaf a file, which each rank reads its
# block of), then the ranks hold 16 B a parameter (float32 master, AdamW m
# and v, float32 gradient) in all plus, a rank, its gathered float32 weights
# and a CUDA context.  qwen3-4b: 36 layers of 100.9 M and 777.8 M of
# embedding and head are 70.6 GB at full depth; cut to 4 layers (18.9 GB;
# 8, 25.4 GB, before rwkv6 and whisper held FSDP + TP at full width too),
# for the run's time (gloo moves every gathered weight through host
# memory).  rwkv6-1.6b cut to 2 layers: 378,062,848 parameters (6.05 GB),
# its constant entries redrawn (_redraw_constants, on the CPU, both sides):
# init's zero bonus u and groupnorm bias put the first token's per-head
# groupnorm at a zero input, its 1/sqrt(eps) regime, where bf16 rounding
# leads u's and ln_x_b's gradients (read on an NVIDIA H100 80GB HBM3 at
# 700 W at 2 layers: u 11.0, ln_x_b 10.6 against one card at step 1, and
# 6e-4 with float32 activations, the mesh exact).  At 8 layers (706,938,880)
# the loss held (0.0027, 0.0037) but not the gradients (u 1.02): random-
# weight RWKV-6 grows rounding with depth in training as in serving (C1;
# on the CPU, d_model 1,024 at 8 layers with constants redrawn, the mesh
# reads u 0.36-0.43 and in float32 activations 0.0015), so 8 layers cannot
# tell a fault from rounding at the bound.  whisper-small whole:
# 266,692,608 (4.27 GB), its 256 frames the serve CLI's.
# (name, layers (0: all), batch, sequence (whisper: its tokens), steps,
# whisper's frames, constants redrawn); the batch splits 2 rows a data shard
LM_MESH_TRAIN_FULL = (("qwen3-4b", 4, 4, 64, 2, 0, False), ("rwkv6-1.6b", 2, 4, 64, 2, 0, True),
                      ("whisper-small", 0, 4, 64, 2, 256, False))
# gates: each leaf's gradient within the family's LMT_GRAD_REL (0.08 but the
# recurrent families' 0.16) in relative L2 at both steps, and the loss a step
# within LM_MESH_TRAIN_LOSS of one card's.  Each meshed step applies the one
# card's gradient it was held against (its block), so the next step starts
# from the one card's weights: AdamW's first update is lr times the
# gradient's sign, and where a gradient element is rounding noise two sides
# that applied their own gradients would start step 2 2 lr apart there
# (read on an NVIDIA H100 80GB HBM3 at 700 W, qwen3-4b at 8 layers: step 1
# 0.00174, step 2 0.0121 apart that way, then held at 0.025)
LM_MESH_TRAIN_LOSS = (LMT_LOSS_ATOL, LMT_LOSS_ATOL)
# recurrentgemma-9b at full width cut to one pattern repeat (rglru, rglru,
# attn) on (1, 4): 2,686,537,728 parameters, of which the untied 256,000 x
# 4,096 embedding and head are 2.10 B: 43.0 GB on one card, 10.75 GB a rank.
# (1, 4) has no "data" gathers: the d_rnn block split and the 16 q heads over
# 4 ranks at full width.  The one-card step runs in rank 0 first and is
# freed; each rank's gradient shards are gathered to rank 0 a leaf at a time
# and held against the same blocks of its one-card gradients (no file).
# (name, layers, batch, sequence, steps); gates LMT_LOSS_ATOL and 0.16
LM_MESH_TRAIN_RG = ("recurrentgemma-9b", 3, 2, 64, 1)
# the reduced configs on (2, 2), each rank's step on the card against the same
# rank on the CPU (an MoE on the CPU's routes), [lm-train]'s card = CPU bounds,
# the card's steps applying the CPU's gradients (so step 2 starts from the
# same weights); rwkv6's constant entries redrawn (LM_MESH_TRAIN_FULL says
# why).  With each side applying its own gradient rwkv6 read 1.03 at init and
# 0.176 redrawn at step 2 (AdamW's first update, lr x sign(g), follows the
# rounding of noise-level gradient elements)
LM_MESH_TRAIN_REDUCED = ("olmoe-1b-7b", "llava-next-34b", "rwkv6-1.6b", "recurrentgemma-9b",
                         "whisper-small")
LM_MESH_TRAIN_REDRAWN = ("rwkv",)  # the families whose constant entries are redrawn
# checkpoints, the reduced qwen3-4b: 3 steps on (2, 2), a checkpoint at step 2
# restored onto (1, 4) and (2, 2) and resumed; full width would write 12 B a
# parameter (19 GB at 8 layers) through zlib, which the card's machine (no
# zstandard) runs at tens of MB/s on one host core
LM_MESH_CKPT = ("qwen3-4b", 3, 2)


def _mesh_batches(cfg, B: int, S: int, steps: int, frames: int = 0) -> list:
    """``steps`` training batches on the CPU: ``lm_batch_fn``'s tokens and
    labels (B, S), and for whisper ``frames`` frame embeddings (B, frames,
    D) bf16, seeded (``frames=0``: S // 2, as the dry run's shapes)."""
    import torch

    from repro_torch.train.loop import lm_batch_fn

    fn = lm_batch_fn(cfg, 1000, S, B, device="cpu")
    out = []
    for i in range(steps):
        b = fn(i)
        if cfg.family == "encdec":
            gen = torch.Generator().manual_seed(1000 + i)
            n = frames or S // cfg.frontend_len_div
            b["frames"] = torch.randn((B, n, cfg.d_model), generator=gen).to(torch.bfloat16)
        out.append(b)
    return out


def _mesh_train_steps(cfg, mesh, dev, batches, routes=None, init_on=None, sink=None,
                      redraw: bool = False, apply=None) -> dict:
    """Float32 masters from ``init(LM_SEED)`` drawn on ``init_on`` (else
    ``dev``; this rank's shards on a ``mesh``; with ``redraw`` drawn whole,
    their constant entries redrawn, :func:`_redraw_constants`, then cut to
    the rank's shards), the optimizer's state, and one train step a batch
    on ``dev``: each step's loss, its gradient tree (host float32; handed
    to ``sink(step, grads)`` instead, when given) and ms (host clock,
    synchronised), an MoE's experts recorded into ``routes`` (an empty
    list) or forced from it (``moe_routes``).  A tree the sink returns, or
    ``apply``'s tree for the step (a list of host gradient trees), is the
    gradient the optimizer applies: a reference's, so that the next step
    starts where the reference's does."""
    import time

    import torch

    from repro_torch.launch.serve import LM_SEED
    from repro_torch.models import get_model
    from repro_torch.models.base import map_leaves, param_shapes, param_specs, shard
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import get_optimizer, tree_map

    model = get_model(cfg, dev)
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    if redraw:
        params = get_model(cfg, init_on or dev).init(LM_SEED, masters=True)
        _redraw_constants(params, LM_SEED + 1)
        if mesh is not None:
            params = map_leaves(lambda _, t, spec: shard(t, spec, mesh), params,
                                param_specs(cfg))
    else:
        params = get_model(cfg, init_on or dev).init(LM_SEED, masters=True, mesh=mesh)
    params = _to(params, dev)
    state = opt.init(params)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    train_step = make_train_step(model, opt, mesh)
    kw = {} if mesh is None else {"mesh": mesh, "specs": param_specs(cfg),
                                  "shapes": param_shapes(cfg)}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"loss": [], "grads": [], "ms": [], "peak": 0}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for b in batches:
        sync()
        t0 = time.perf_counter()
        with moe_routes(routes if routes is not None else []):
            loss, grads = train_step.grads(params, {k: v.to(dev) for k, v in b.items()})
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        out["loss"].append(float(loss))
        i = len(out["loss"]) - 1
        if sink is None:
            out["grads"].append(tree_map(lambda g: g.float().cpu().numpy(), grads))
        else:
            grads = sink(i, grads) or grads
        if apply is not None:
            grads = tree_map(lambda a: torch.from_numpy(a).to(dev), apply[i])
        sync()
        t0 = time.perf_counter()
        opt.update(grads, state, params, step, **kw)
        step.add_(1)
        sync()
        out["ms"].append(ms + (time.perf_counter() - t0) * 1e3)
        del grads
    if dev.type == "cuda":
        out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["shard_bytes"] = sum(t.nbytes for _, t in _named_paths(params))
    return out


def _empty_cache(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _fit_ckpt_rank(cfg, mesh, dev, tmp: str) -> dict:
    """:data:`LM_MESH_CKPT` on this rank: ``fit`` for the steps
    uninterrupted, then to the checkpoint step, a crash, and a resume
    (every rank's masters host float32), and the checkpoint restored onto
    a (1, 4) and a (2, 2) mesh (this rank's shards)."""
    import os

    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import get_model
    from repro_torch.train.loop import fit, lm_batch_fn, state_layout
    from repro_torch.train.optimizer import get_optimizer, tree_map

    _, steps, every = LM_MESH_CKPT
    model = get_model(cfg, dev)
    batches = lm_batch_fn(cfg, 100, 16, 4, device=dev)
    host = lambda tree: tree_map(lambda t: t.cpu().numpy(), tree)  # noqa: E731
    whole, _ = fit(model, batches, steps=steps, mesh=mesh)
    ckpt_dir = os.path.join(tmp, "lm-mesh-ckpt")
    saved, _ = fit(model, batches, steps=every, ckpt_dir=ckpt_dir, ckpt_every=every, mesh=mesh)
    resumed, losses = fit(model, batches, steps=steps, ckpt_dir=ckpt_dir, ckpt_every=every,
                          mesh=mesh)
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    specs, _ = state_layout(cfg, opt)
    template = {"params": saved, "opt": opt.init(saved)}
    onto = {}
    for shape in ((1, 4), (2, 2)):
        m = RankMesh(shape, device_type=dev.type)
        onto[shape] = {"coords": m.coords,
                       "params": host(ckpt.restore(ckpt_dir, every, template, dev, mesh=m,
                                                   specs=specs)["params"])}
    return {"coords": mesh.coords, "whole": host(whole), "saved": host(saved),
            "resumed": host(resumed), "resumed_losses": losses, "onto": onto}


def _grad_file(tmp: str, name: str, step: int, n: int) -> str:
    import os

    return os.path.join(tmp, f"one-card-grad-{name}-{step}-{n}.npy")


def _np_block(a, spec, mesh):
    """This rank's block of the whole array ``a`` sharded as ``spec``
    (``base.shard`` on a host array, read from a memory map block by
    block), zero-padded as XLA pads."""
    from repro_torch.launch.mesh import entry_index, shard_shape

    spec = tuple(spec) + (None,) * (a.ndim - len(spec))
    padded = shard_shape(a.shape, spec, mesh)
    idx = []
    for n, c, e in zip(a.shape, padded, spec):
        lo = min(entry_index(e, mesh) * c, n)
        idx.append(slice(lo, min(lo + c, n)))
    out = np.zeros(padded, dtype=a.dtype)
    block = a[tuple(idx)]
    out[tuple(slice(0, m) for m in block.shape)] = block
    return out


def _full_width_rank(name: str, layers: int, mesh, device, batches, tmp: str,
                     redraw: bool) -> dict:
    """One :data:`LM_MESH_TRAIN_FULL` case on this rank: its steps on
    ``mesh``, each step's gradient shards held against the same blocks of
    the one card's (``tmp``'s files): {path: (sum of squared differences,
    of squares)} a step.  Each step's update applies those blocks of the
    one card's gradient, so every step starts from the one card's
    weights."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.base import param_specs

    cfg = _depth(get_config(name), layers)
    specs = dict(_spec_paths(param_specs(cfg)))
    stats = [{} for _ in batches]

    def compare(i, grads):
        ref = {}
        for n, (path, g) in enumerate(_named_paths(grads)):
            w = _np_block(np.load(_grad_file(tmp, name, i, n), mmap_mode="r"), specs[path],
                          mesh)
            ref[path] = torch.from_numpy(w).to(device)
            w = ref[path].double()
            stats[i][path] = (float(torch.sum((g.double() - w) ** 2)), float(torch.sum(w * w)))
        return _with_paths(lambda path, _: ref[path], grads)

    out = _mesh_train_steps(cfg, mesh, device, batches, sink=compare, redraw=redraw,
                            init_on=torch.device("cpu") if redraw else None)
    out["stats"] = stats
    return out


def _rg_rank(mesh, device) -> dict:
    """:data:`LM_MESH_TRAIN_RG`: rank 0 runs the one-card steps and keeps
    their gradients on the host (the card freed), then every rank runs the
    steps on ``mesh`` (1, 4); each leaf's gradient shards are gathered to
    rank 0 (gloo, host memory) and held against the same blocks of the one
    card's.  Rank 0 returns the one card's run and the stats a rank."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models.base import param_specs

    name, layers, B, S, steps = LM_MESH_TRAIN_RG
    cfg = _depth(get_config(name), layers)
    batches = _mesh_batches(cfg, B, S, steps)
    specs = dict(_spec_paths(param_specs(cfg)))
    rank, n = dist.get_rank(), mesh.axis_size("model")
    whole = [{} for _ in batches]
    one = None
    if rank == 0:
        def keep(i, grads):
            whole[i].update((p, g.float().cpu().numpy()) for p, g in _named_paths(grads))

        one = _mesh_train_steps(cfg, None, device, batches, sink=keep)
        gc.collect()
        _empty_cache(device)
    dist.barrier()
    stats = [[{} for _ in batches] for _ in range(n)]

    def compare(i, grads):
        for path, g in _named_paths(grads):
            t = g.float().cpu().contiguous()
            got = [torch.empty_like(t) for _ in range(n)] if rank == 0 else None
            dist.gather(t, got, dst=0)
            for r, blk in enumerate(got or []):  # rank 0: the sums on the card
                w = _np_block(whole[i][path], specs[path], _Coords((1, n), {"data": 0,
                                                                            "model": r}))
                w = torch.from_numpy(w).to(device, torch.float64)
                stats[r][i][path] = (float(torch.sum((blk.to(device, torch.float64) - w) ** 2)),
                                     float(torch.sum(w * w)))
            del got

    out = _mesh_train_steps(cfg, mesh, device, batches, sink=compare)
    del whole
    if rank == 0:
        out.update({"one": one, "stats_by_rank": stats})
    return out


def lm_mesh_train_rank(rank, device, reduced_batches, tmp: str) -> dict:
    """One rank of ``[lm-mesh-train]``: each :data:`LM_MESH_TRAIN_FULL` case
    on (2, 2) against the one card's files, :data:`LM_MESH_TRAIN_RG` on
    (1, 4), then the reduced configs on the CPU and on the card, then the
    checkpoints (:func:`_fit_ckpt_rank`).  The seconds of each part are
    returned too."""
    import gc
    import time

    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch.mesh import RankMesh

    t0 = time.perf_counter()
    mesh = RankMesh((2, 2), device_type=device.type)
    mesh14 = RankMesh((1, 4), device_type=device.type)
    out = {"coords": mesh.coords, "seconds": {}}
    for name, layers, B, S, steps, frames, redraw in LM_MESH_TRAIN_FULL:
        t = time.perf_counter()
        cfg = _depth(get_config(name), layers)
        batches = _mesh_batches(cfg, B, S, steps, frames)
        out["full", name] = _full_width_rank(name, layers, mesh, device, batches, tmp, redraw)
        gc.collect()
        _empty_cache(device)
        out["seconds"][name] = time.perf_counter() - t
    t = time.perf_counter()
    out["rg"] = _rg_rank(mesh14, device)
    gc.collect()
    _empty_cache(device)
    out["seconds"][LM_MESH_TRAIN_RG[0]] = time.perf_counter() - t
    t = time.perf_counter()
    cpu = torch.device("cpu")
    for name in LM_MESH_TRAIN_REDUCED:
        cfg = get_reduced(name)
        routes: list = []  # the CPU's, recorded, then forced on the card
        redraw = cfg.family in LM_MESH_TRAIN_REDRAWN
        run = {"cpu": _mesh_train_steps(cfg, mesh, cpu, reduced_batches[name], routes,
                                        init_on=cpu, redraw=redraw)}
        # the card applies the CPU's gradients: each step starts from the CPU's weights
        run["card"] = _mesh_train_steps(cfg, mesh, device, reduced_batches[name], routes,
                                        init_on=cpu, redraw=redraw, apply=run["cpu"]["grads"])
        out[name] = run
    out["seconds"]["reduced"] = time.perf_counter() - t
    t = time.perf_counter()
    out["ckpt"] = _fit_ckpt_rank(get_reduced(LM_MESH_CKPT[0]), mesh, device, tmp)
    out["seconds"]["checkpoints"] = time.perf_counter() - t
    out["seconds"]["all"] = time.perf_counter() - t0
    return out


class _Coords:
    """A rank's coordinates on a (data, model) mesh, for ``base.shard``."""

    def __init__(self, shape, coords):
        self.axis_names, self.sizes, self.coords = ("data", "model"), tuple(shape), coords

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.sizes))

    def axis_size(self, a):
        return self.shape[a]

    def axis_index(self, a):
        return self.coords[a]


def _spec_paths(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _spec_paths(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_paths(v, f"{path}[{i}]")
    else:
        yield path, tree


def _assemble(blocks: list, spec, shape, mesh_shape):
    """The whole leaf of ``shape`` from every rank's block ([(coords,
    block)]) of a ``mesh_shape`` (data, model) mesh, sharded as ``spec``,
    the padding dropped: a host-side check of what a meshed save gathers."""
    out = np.zeros(shape, dtype=blocks[0][1].dtype)
    for coords, b in blocks:
        idx = []
        for n, c, e in zip(shape, b.shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
            i = 0 if e is None else coords[e] if e in coords else 0
            lo = min(i * c, n)
            idx.append(slice(lo, min(lo + c, n)))
        out[tuple(idx)] = b[tuple(slice(0, s.stop - s.start) for s in idx)]
    return out


def _rel_by_step(runs: list, steps: int) -> list:
    """Relative L2 a leaf a step over every rank's ``stats`` ({path: (sum of
    squared differences, of squares)} a step): [{path: rel}] a step."""
    rel = []
    for i in range(steps):
        num = {p: sum(r[i][p][0] for r in runs) for p in runs[0][i]}
        den = {p: sum(r[i][p][1] for r in runs) for p in num}
        rel.append({p: (num[p] / den[p]) ** 0.5 if den[p] else num[p] ** 0.5 for p in num})
    return rel


def _full_width_verdict(name, layers, B, S, steps, one, full, mesh: str, smi: str,
                        frames: int = 0, loss_gate=LM_MESH_TRAIN_LOSS) -> None:
    """Print one full-width case's meshed steps against one card's and fail
    unless the loss a step and every leaf's gradient are within their gates
    and every rank's loss is the same."""
    from repro_torch.configs import get_config
    from repro_torch.models.base import param_shapes

    cfg = _depth(get_config(name), layers)
    grad_gate = LMT_GRAD_REL.get(cfg.family, LMT_GRAD_REL_DEFAULT)
    rel = _rel_by_step([r["stats"] for r in full], steps)
    dloss = [abs(max(r["loss"][i] for r in full) - one["loss"][i]) for i in range(steps)]
    spread = [max(r["loss"][i] for r in full) - min(r["loss"][i] for r in full)
              for i in range(steps)]
    worst = [max(x.items(), key=lambda kv: kv[1]) for x in rel]
    top = [sorted(x.items(), key=lambda kv: -kv[1])[:3] for x in rel]
    n_params = sum(int(np.prod(s)) for _, s in _spec_paths(param_shapes(cfg)))
    step_ms = [max(r["ms"][i] for r in full) for i in range(steps)]
    depth = f"cut to {layers} layers" if layers else "at full depth"
    side = f", {frames} frames" if frames else ""
    print(f"[lm-mesh-train] {name} full width {depth} ({n_params:,} parameters, 16 B each = "
          f"{16 * n_params / 1e9:.2f} GB) on a {mesh} mesh of {LM_MESH_RANKS} gloo ranks on "
          f"one card (B={B}, S={S}{side}, {steps} AdamW step(s)) against one card's steps on "
          f"the same weights and batches: loss a step one card "
          f"{', '.join(f'{x:.6f}' for x in one['loss'])}, meshed "
          f"{', '.join(f'{max(r['loss'][i] for r in full):.6f}' for i in range(steps))} "
          f"(|Δ| {', '.join(f'{x:.3g}' for x in dloss)}, gate <= "
          f"{', '.join(map(str, loss_gate[:steps]))}; ranks apart by "
          f"{', '.join(f'{x:.3g}' for x in spread)}); worst leaves' gradient relative L2 a "
          f"step {'; '.join(', '.join(f'{p} {v:.4g}' for p, v in t) for t in top)} (gate <= "
          f"{grad_gate}); ms a "
          f"step meshed (slowest rank, host clock) {', '.join(f'{t:.1f}' for t in step_ms)} "
          f"vs one card {', '.join(f'{t:.1f}' for t in one['ms'])}; shards "
          f"{full[0]['shard_bytes']:,} B a rank, peak memory_allocated a rank "
          f"{max(r['peak'] for r in full):,} B vs one card {one['peak']:,} B; card: {smi}")
    if any(d > g for d, g in zip(dloss, loss_gate)) or max(v for _, v in worst) > grad_gate \
            or max(spread) != 0:
        raise SystemExit(f"[lm-mesh-train] {name} on the mesh leaves one card: loss "
                         f"{dloss}, ranks apart {spread}, worst {worst}")


def lm_mesh_train_phase(dev, smi: str) -> dict:
    """Slices 15-16 on the card: the :data:`LM_MESH_TRAIN_FULL` one-card
    reference steps (``make_train_step`` without a mesh, each freed before
    the next), then one world of ``LM_MESH_RANKS`` gloo ranks sharing the
    card: the same steps on (2, 2) (loss and every leaf's gradient against
    one card's), :data:`LM_MESH_TRAIN_RG` on (1, 4) against its one-card
    step run in rank 0, the reduced :data:`LM_MESH_TRAIN_REDUCED` on (2, 2)
    on the card against the same ranks on the CPU, and
    :data:`LM_MESH_CKPT`'s checkpoints: resumed = an uninterrupted fit to
    the bit, and the checkpoint restored onto (1, 4) and (2, 2) equal to
    the saved leaves to the bit."""
    import gc
    import tempfile
    import time

    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.gbdt.distributed import run_ranks
    from repro_torch.models.base import param_shapes, param_specs, shard

    t_phase = time.perf_counter()
    reduced_batches = {rname: _mesh_batches(get_reduced(rname), 4, 16, 2)
                       for rname in LM_MESH_TRAIN_REDUCED}
    ones = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, layers, B, S, steps, frames, redraw in LM_MESH_TRAIN_FULL:
            cfg = _depth(get_config(name), layers)

            def save(i, grads, name=name):  # one card's gradients, a file a leaf
                for n, (_, g) in enumerate(_named_paths(grads)):
                    np.save(_grad_file(tmp, name, i, n), g.float().cpu().numpy())

            ones[name] = _mesh_train_steps(
                cfg, None, dev, _mesh_batches(cfg, B, S, steps, frames), sink=save,
                redraw=redraw, init_on=torch.device("cpu") if redraw else None)
            gc.collect()
            _empty_cache(dev)
        one_s = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        ranks = run_ranks(lm_mesh_train_rank, LM_MESH_RANKS, reduced_batches, tmp,
                          device=dev)
    ranks_s = time.perf_counter() - t0

    # (a) full width on (2, 2) against one card
    for name, layers, B, S, steps, frames, _ in LM_MESH_TRAIN_FULL:
        _full_width_verdict(name, layers, B, S, steps, ones[name],
                            [r["full", name] for r in ranks], "(2, 2)", smi, frames)
    # (b) recurrentgemma-9b on (1, 4) against its one-card step in rank 0
    name, layers, B, S, steps = LM_MESH_TRAIN_RG
    rg = [r["rg"] for r in ranks]
    for r, st in zip(rg, rg[0]["stats_by_rank"]):
        r["stats"] = st
    _full_width_verdict(name, layers, B, S, steps, rg[0]["one"], rg, "(1, 4)", smi,
                        loss_gate=(LMT_LOSS_ATOL,))
    del ones, rg

    # (c) the reduced configs on (2, 2): the card's ranks against the CPU's
    for rname in LM_MESH_TRAIN_REDUCED:
        rcfg = get_reduced(rname)
        cpu = [{**r[rname]["cpu"], "coords": r["coords"]} for r in ranks]
        card = [{**r[rname]["card"], "coords": r["coords"]} for r in ranks]
        d = max(abs(a["loss"][i] - b["loss"][i]) for a, b in zip(cpu, card) for i in range(2))
        worst = 0.0
        for a, b in zip(cpu, card):
            for i in range(2):
                for (path, x), (_, y) in zip(_named_paths(a["grads"][i]),
                                             _named_paths(b["grads"][i])):
                    if rcfg.top_k == 1 and path.endswith("router"):
                        continue
                    n = np.linalg.norm(x.astype(np.float64))
                    worst = max(worst, float(np.linalg.norm(y - x) / n) if n else 0.0)
        gate = LMT_GRAD_REL.get(rcfg.family, LMT_GRAD_REL_DEFAULT)
        print(f"[lm-mesh-train] {rname} reduced on a (2, 2) mesh (B=4, S=16, 2 AdamW "
              f"steps), the card's ranks vs the same ranks on the CPU: loss |Δ| {d:.3g} (gate "
              f"<= {LMT_LOSS_ATOL}), worst gradient shard relative L2 {worst:.4g} (gate <= "
              f"{gate}); card: {smi}")
        if d > LMT_LOSS_ATOL or worst > gate:
            raise SystemExit(f"[lm-mesh-train] {rname} on the card's mesh leaves the CPU's")

    # (d) checkpoints: resume to the bit, restore onto (1, 4) and (2, 2) to the bit
    ccfg = get_reduced(LM_MESH_CKPT[0])
    specs = dict(_spec_paths(param_specs(ccfg)))
    shapes = dict(_spec_paths(param_shapes(ccfg)))
    resumed = all(np.array_equal(a, b) for r in ranks
                  for (_, a), (_, b) in zip(_named_paths(r["ckpt"]["whole"]),
                                            _named_paths(r["ckpt"]["resumed"])))
    saved = {p: _assemble([(r["ckpt"]["coords"], dict(_named_paths(r["ckpt"]["saved"]))[p])
                           for r in ranks], specs[p], shapes[p], (2, 2)) for p in specs}
    restored = {}
    for shape in ((1, 4), (2, 2)):
        ok = True
        for r in ranks:
            o = r["ckpt"]["onto"][shape]
            got = dict(_named_paths(o["params"]))
            mesh = _Coords(shape, o["coords"])
            for p, w in saved.items():
                ok &= np.array_equal(got[p], shard(torch.from_numpy(w), specs[p], mesh).numpy())
        restored[shape] = ok
    print(f"[lm-mesh-train] checkpoints ({LM_MESH_CKPT[0]} reduced on (2, 2), "
          f"{LM_MESH_CKPT[1]} steps, a checkpoint at step {LM_MESH_CKPT[2]}): resumed = "
          f"uninterrupted to the bit on every rank: {resumed}; the checkpoint restored onto "
          f"(1, 4) and (2, 2), every rank's shards = the saved leaves' blocks to the bit: "
          f"{restored[(1, 4)]}, {restored[(2, 2)]}")
    if not (resumed and all(restored.values())):
        raise SystemExit("[lm-mesh-train] a meshed checkpoint does not restore to the bit")
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in ranks[0]["seconds"].items())
    print(f"[lm-mesh-train] one card {one_s:.1f} s; ranks {ranks_s:.1f} s ({parts}, rank 0); "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"ranks_s": ranks_s}


def main() -> int:
    import json
    import subprocess
    import tempfile
    import time

    import torch

    t_start = time.perf_counter()

    def clock(phase: str) -> None:
        """The run's elapsed seconds at the end of a phase (where the time goes)."""
        print(f"[clock] {phase} ends at {time.perf_counter() - t_start:.1f} s")

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
    print(f"[host] {platform.node()}, {platform.machine()}, {os.cpu_count()} CPUs, "
          f"load average {os.getloadavg()[0]:.2f}")

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
    max_abs_err = check_predict_kernel(dev, on_card, full, x_full)
    hist_err = check_histogram_kernel(dev)
    ee_err = check_early_exit_kernel(dev)
    bin_err = check_binning_kernel(dev)
    commit = check_commit_kernel(dev, smi)
    clock("kernel checks")

    # ---- 4. serve: the port's main path ------------------------------------
    from repro_torch.api import ToadModel
    from repro_torch.launch import serve

    config = serving_config()
    with tempfile.TemporaryDirectory() as tmp:
        serve_model = ToadModel.from_forest(full_forest, config, n_bins=256, device=dev) \
            .compress()
        path = serve_model.save(f"{tmp}/m.toad")
        packed_predict.launches = 0
        served = serve.main(["--arch", "toad-gbdt", "--model", path,
                             "--backend", "cuda", "--requests", "2048",
                             "--clients", "4"])
        launches = packed_predict.launches
        if served["backend"] != "cuda" or launches < served["n_batches"]:
            raise SystemExit(f"[serve] the kernel ran {launches} time(s) for "
                             f"{served['n_batches']} batches on {served['backend']}")
        print(f"[serve] {served['n_requests']} requests in {served['n_batches']} "
              f"batches, {served['req_per_s']:.1f} req/s, p50 "
              f"{served['latency_p50_ms']:.2f} ms, parity {served['max_abs_err']:.2e}; "
              f"packed_predict launches {launches}")
        serve_host_split(dev, smi, serve_model, x_full)

        # ---- 4a. slice 5: serving resilience on the same model -------------
        resilience_phase(dev, serve_model, path, x_full)

        # ---- 4a'. slice 6: the .toadpack container, progressive scoring ----
        stream_phase(dev, smi, serve_model, synthetic_forest(0), config, x_full, tmp)
        del serve_model
    clock("serve, resilience, stream")

    # ---- 4b. train: the port's main training path, then the CLI's ---------
    from repro_torch.kernels.histogram import histogram

    trained, X_train, fit = train_full_width(dev, smi)
    # ---- 4b'. binning: B4's entry point on the training phase's rows -----
    binned = binning_full_width(dev, smi, X_train, fit["edges"])
    card_equals_cpu(dev)
    clock("train, binning, card = CPU")
    # ---- 4b''. slice 8: the paper's baselines, data-parallel training ----
    baselines_phase(dev, smi, fit, X_train)
    del X_train
    with tempfile.TemporaryDirectory() as tmp:
        data_parallel_phase(dev, smi, fit, tmp)
    clock("baselines, data-parallel")
    del fit
    torch.cuda.empty_cache()
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
        # slice 6's early exit: the same model streamed, on its held-out rows
        stream_early_exit(dev, ee["model"], ee.pop("Xh"), tmp)
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

    # ---- 4d. compression under a budget, save, toadcheck, load, serve -----
    with tempfile.TemporaryDirectory() as tmp:
        compress_full_width(dev, smi, ee.pop("model"), tmp)
    clock("early exit, compression")

    # ---- 4e. slice 7: the multi-model fleet (B1, B3) -----------------------
    with tempfile.TemporaryDirectory() as tmp:
        fleet_phase(dev, smi, tmp)
    clock("fleet")

    # ---- 4f. slices 9-10: the LM serving path (no kernel of the repo on it)
    from repro_torch.kernels.binning import binning
    from repro_torch.kernels.commit import commit_level

    kernels = (packed_predict, histogram, packed_predict_early_exit, binning, commit_level)
    for k in kernels:
        k.launches = 0
    lm_phase(dev, smi)
    if any(k.launches for k in kernels):
        raise SystemExit(f"[lm] a ToaD kernel ran on the LM path: "
                         f"{[k.launches for k in kernels]}")
    print("[lm] kernel launches during the phase: 0 (the LM path reaches no "
          "pallas_call in the JAX package, so it has no kernel here)")
    clock("lm")

    # ---- 4g. slice 11: LM training (no kernel of the repo on it) ----------
    for k in kernels:
        k.launches = 0
    lm_train_phase(dev, smi)
    if any(k.launches for k in kernels):
        raise SystemExit(f"[lm-train] a ToaD kernel ran on the LM training path: "
                         f"{[k.launches for k in kernels]}")
    print("[lm-train] kernel launches during the phase: 0 (the JAX package trains its "
          "LMs in plain jnp, so the path has no kernel here)")
    clock("lm-train")

    # ---- 4h. slice 12: the dry run's meta trace against the card ----------
    for k in kernels:
        k.launches = 0
    dryrun_phase(dev, smi)
    if any(k.launches for k in kernels):
        raise SystemExit(f"[dryrun] a ToaD kernel ran: {[k.launches for k in kernels]}")
    print("[dryrun] kernel launches during the phase, the meshed cells included: 0")
    clock("dryrun")

    # ---- 4i. slice 13: LM serving on a (data, model) mesh (no kernel on it)
    for k in kernels:
        k.launches = 0
    lm_mesh_phase(dev, smi)
    if any(k.launches for k in kernels):
        raise SystemExit(f"[lm-mesh] a ToaD kernel ran: {[k.launches for k in kernels]}")
    print("[lm-mesh] kernel launches during the phase: 0")
    clock("lm-mesh")

    # ---- 4j. slice 15: LM training on a (data, model) mesh (no kernel on it)
    for k in kernels:
        k.launches = 0
    lm_mesh_train_phase(dev, smi)
    if any(k.launches for k in kernels):
        raise SystemExit(f"[lm-mesh-train] a ToaD kernel ran: {[k.launches for k in kernels]}")
    print("[lm-mesh-train] kernel launches during the phase: 0 (the JAX package trains its "
          "LMs in plain jnp on a mesh too, so the path has no kernel here)")
    clock("lm-mesh-train")

    # ---- 5. time: plain, kernel, kernel, plain ----------------------------
    T, I = full.words.shape
    D, C = full.max_depth, full.n_ensembles

    def timed(n, kernel_reps, plain_reps):
        xt = torch.from_numpy(x_full[:n]).to(dev)
        kernel = lambda: packed_predict(xt, *full.arrays(), **full.meta(),
                                        max_feature=full.max_feature)
        plain = lambda: packed_predict_ref(xt, *full.arrays(), **full.meta())
        runs = [("plain", _time_ms(plain, plain_reps)),
                ("kernel", _time_ms(kernel, kernel_reps, queued=True)),
                ("kernel", _time_ms(kernel, kernel_reps, queued=True)),
                ("plain", _time_ms(plain, plain_reps))]
        kernel_ms = float(np.mean([t for k, t in runs if k == "kernel"]))
        plain_ms = float(np.mean([t for k, t in runs if k == "plain"]))
        host_ms = _host_ms(kernel, kernel_reps)
        n_bytes, n_ops, path_scores = needed_work(full, xt)
        if not torch.allclose(path_scores, kernel(), rtol=1e-5, atol=1e-5):
            raise SystemExit(f"[time] n={n}: the counted paths are not the kernel's")
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"[time] n={n}, T={T}, depth {D}, d={xt.shape[1]} ({plan_of(full, n).describe()}): "
              + ", ".join(f"{k} {t:.4f} ms" for k, t in runs)
              + f"; the wrapper's host time per call {host_ms:.4f} ms")
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
    del xt
    level0, tree_err = time_tree_histograms(dev, smi, trained["launches"])
    hist_err = max(hist_err, tree_err)

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
    }, {
        "name": "binning",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/binning.cu",
        "replaces": "src/repro/kernels/binning.py:20",
        "launches": binned["launches"],
        "max_abs_err": bin_err,
        "ms": binned["ms"],
        "plain_ms": binned["plain_ms"],
        "bound_ms": binned["bound_ms"],
        "bound_by": binned["bound_by"],
        "library_ms": binned["library_ms"],
    }, {
        "name": "commit_level",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/commit.cu",
        "replaces": None,
        "launches": trained["commit_launches"],
        "max_abs_err": 0.0,
        **commit,
    }]}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
