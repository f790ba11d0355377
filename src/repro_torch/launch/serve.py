"""Serving launcher of the port: a ToaD model behind the micro-batching
engine, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch toad-gbdt \
        --model model.toad                    # cuda backend on an H100
    PYTHONPATH=src python -m repro_torch.launch.serve --arch toad-gbdt \
        --model model.toad --device cpu --backend packed --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch toad-gbdt \
        --device cpu --smoke                  # trains in-process first
    PYTHONPATH=src python -m repro_torch.launch.serve --arch toad-gbdt \
        --model model.toad --early-exit 0     # early-exit kernel on an H100

With ``--model`` the artifact is loaded through ``load_checked`` (format
version, stream digest, eval-fingerprint probe) and the requests are its
own fingerprint probe rows.  Without it the reduced ``toad_gbdt`` workload
is trained in-process on ``--device`` (synthetic rows drawn from a seed),
compressed, and served on its training rows.  Either way every served
score is checked against the ``reference`` backend (<= 1e-5).  With
``--early-exit EPSILON`` the engine serves through an
``EarlyExitPredictor`` (the early-exit kernel on the ``cuda`` backend), so
exited rows carry partial sums: the check is then exact labels against the
``reference`` backend's, and the mean trees evaluated is printed.

Not here yet: ``--arch toad-fleet``, the LM path and the resilience flags.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import time

import numpy as np

GBDT_ARCHS = ("toad-gbdt", "toad_gbdt")
PARITY_ATOL = 1e-5


def load_model(args, device, n_requests):
    """The artifact at ``--model``, loaded and checked, and its own
    eval-fingerprint probe rows tiled to the request count (parity is
    checked on exactly the inputs it was fingerprinted on)."""
    from repro_torch.api.artifact import ArtifactError, load_checked
    from repro_torch.core.pipeline import probe_inputs

    print(f"verifying + loading artifact {args.model} ...")
    try:
        loaded = load_checked(args.model, device=device)
    except ArtifactError as e:
        raise SystemExit(f"refusing to serve: {e}")
    print("toadcheck: not in this port yet")
    model = loaded.model
    if not model.is_compressed:
        model.compress()
    meta = model.artifact_meta or {}
    manifest = meta.get("manifest", {})
    spec = meta.get("spec") or {}
    print(f"artifact: format v{loaded.format_version}, "
          f"spec {spec.get('name', 'pre-spec')!r}, "
          f"{manifest.get('encoded_stream_bytes', 0):.0f} B encoded, "
          f"{manifest.get('n_trees', int(model.forest.n_trees))} trees")
    fp = meta.get("fingerprint") or {}
    probe = probe_inputs(model.forest, n=int(fp.get("n_probe", 32)),
                         seed=int(fp.get("seed", 7)))
    n_pool = max(n_requests, 256)
    return model, np.tile(probe, (-(-n_pool // len(probe)), 1))[:n_pool]


def train_model(args, device):
    """The reduced workload of ``--arch``, trained in-process on ``device``
    from synthetic rows (a nonlinear rule of three features), compressed;
    returns the model and its training rows."""
    from repro_torch.api import ToadModel
    from repro_torch.configs import get_gbdt_config

    # always the reduced workload: the full one is 16.7M rows, not something
    # to train on a serving host before it serves
    wl = get_gbdt_config(args.arch, reduced=True)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(wl.rows, wl.n_features)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + 0.3 * X[:, 2] ** 2 > 0).astype(np.float32)
    print(f"training toad-gbdt on {device} (rows={wl.rows}, d={wl.n_features}, "
          f"rounds={wl.gbdt.n_rounds}, depth={wl.gbdt.max_depth}) ...")
    t0 = time.perf_counter()
    model = ToadModel(config=wl.gbdt, n_bins=wl.n_bins, device=device).fit(X, y)
    print(f"trained in {time.perf_counter() - t0:.2f}s, "
          f"train metric {model.score(X, y, backend='reference'):.4f}")
    return model.compress(), X


def serve_gbdt(args) -> dict:
    """Serve the artifact's probe rows (or the in-process model's training
    rows) through the engine; returns the engine stats plus the parity
    error and the backend that served."""
    from repro_torch._device import resolve_device
    from repro_torch.api import EarlyExitPolicy, GBDTEngine, available_backends, get_backend
    from repro_torch.gbdt.early_exit import predict_label_from_scores

    ee_policy = None
    if args.early_exit is not None:
        ee_policy = EarlyExitPolicy(epsilon=args.early_exit)
    device = resolve_device(args.device)
    backend = args.backend
    if backend != "auto":
        get_backend(backend)  # fail fast on a typo'd name, before loading
    n_requests = 256 if args.smoke else args.requests
    if args.model:
        model, X = load_model(args, device, n_requests)
    else:
        model, X = train_model(args, device)

    report = model.memory_report()
    print(f"model: {int(report['n_trees'])} trees, "
          f"{report['toad_bytes']:.0f} B ToaD stream "
          f"({report['compression_vs_f32']:.1f}x vs fp32 pointers), "
          f"ReF={report['reuse_factor']:.2f}")
    print(f"backend: {backend} (available on {device}: "
          f"{', '.join(available_backends(device))})")

    engine = GBDTEngine(
        model, backend=None if backend == "auto" else backend,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        early_exit=ee_policy,
    )
    rng = np.random.default_rng(0)
    queries = X[rng.integers(0, X.shape[0], size=n_requests)]
    scores = np.zeros((n_requests, model.forest.n_ensembles), np.float32)

    def client(lo: int, hi: int) -> None:
        futs = [engine.submit(queries[i]) for i in range(lo, hi)]
        scores[lo:hi] = np.stack([f.result() for f in futs])

    bounds = [(c * n_requests // args.clients, (c + 1) * n_requests // args.clients)
              for c in range(args.clients)]
    with engine, concurrent.futures.ThreadPoolExecutor(args.clients) as pool:
        # the window holds the serving alone: it ends when the last future
        # resolves, and the parity check runs after it
        t0 = time.perf_counter()
        jobs = [pool.submit(client, lo, hi) for lo, hi in bounds if hi > lo]
        for j in jobs:
            j.result()
        wall = time.perf_counter() - t0

    s = engine.stats()
    ref = model.predict(queries, backend="reference")
    max_err = float(np.abs(scores - ref).max()) if n_requests else 0.0
    print(f"served {s.n_requests} requests in {wall:.2f}s — "
          f"{s.n_requests / wall:.1f} req/s, mean batch {s.mean_batch:.1f}, "
          f"p50 {s.latency_p50_ms:.2f} ms, p95 {s.latency_p95_ms:.2f} ms")
    mismatches = None
    if ee_policy is None:
        print(f"parity vs reference backend: max|Δ| = {max_err:.2e}")
    else:
        # exited rows carry partial sums, so score parity is the wrong
        # check: the early-exit contract is exact labels
        task = model.config.task
        mismatches = int(np.sum(predict_label_from_scores(scores, task)
                                != predict_label_from_scores(ref, task)))
        print(f"early-exit: trees_evaluated mean {s.mean_trees_evaluated:.2f} / "
              f"{int(model.forest.n_trees)} trees (exact-label mismatches = "
              f"{mismatches})")
    if args.scores_out:
        np.savez(args.scores_out, queries=queries, scores=scores)
    if s.n_requests != n_requests:
        raise SystemExit(f"served {s.n_requests} of {n_requests} requests")
    if mismatches:
        raise SystemExit(f"{mismatches} early-exited request(s) changed their label")
    if ee_policy is None and not max_err <= PARITY_ATOL:
        raise SystemExit(f"parity {max_err:.2e} exceeds {PARITY_ATOL:g}")
    return {**s.as_dict(), "req_per_s": s.n_requests / wall,
            "max_abs_err": max_err, "label_mismatches": mismatches,
            "backend": engine.backend}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, help="toad-gbdt")
    ap.add_argument("--model", default=None,
                    help="path to a prebuilt .toad artifact to serve "
                         "(default: train the reduced workload in-process)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "reference", "packed", "cuda"),
                    help="predictor backend (auto: cuda on an H100)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--smoke", action="store_true",
                    help="short run (256 requests)")
    ap.add_argument("--early-exit", type=float, default=None, metavar="EPSILON",
                    help="serve with a label-exact early-exit policy of this "
                         "margin slack (0 is already sound; inf never exits)")
    ap.add_argument("--scores-out", default=None,
                    help="write the served rows and their scores to this .npz")
    args = ap.parse_args(argv)
    if args.arch not in GBDT_ARCHS:
        ap.error(f"only --arch toad-gbdt is ported so far, got {args.arch!r}")
    return serve_gbdt(args)


if __name__ == "__main__":
    main()
