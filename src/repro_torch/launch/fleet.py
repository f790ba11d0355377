"""Fleet serving launcher of the port: many ``.toad`` artifacts behind one
router, on the card.

    # Dry run: toadcheck every artifact, admit it, print the planned fleet
    # manifest (model ids, versions, negotiated formats, dedup plan) and
    # the residency report — no serving:
    PYTHONPATH=src python -m repro_torch.launch.fleet --models fleet_dir/ --dry-run

    # Serve: route client requests across every hosted model (B1, the cuda
    # backend, on an H100), check routed predictions against each model's
    # reference backend:
    PYTHONPATH=src python -m repro_torch.launch.fleet --models fleet_dir/ \
        --requests 2048 --clients 4

    # Short run on the CPU + a live hot-swap after the traffic:
    PYTHONPATH=src python -m repro_torch.launch.fleet --models fleet_dir/ \
        --device cpu --smoke --swap tenant_a=new_model.toad

    # Progressive cold-start over .toadpack streaming containers: each
    # model answers from its first tree block, the rest stream in:
    PYTHONPATH=src python -m repro_torch.launch.fleet --models fleet_dir/ \
        --smoke --streaming

    # Adaptive early exit (B3 on an H100): stop scoring a row once its
    # label is provably final within the margin bound:
    PYTHONPATH=src python -m repro_torch.launch.fleet --models fleet_dir/ \
        --smoke --early-exit 0

Also reachable through the serving CLI's arch dispatch::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch toad-fleet \
        --models fleet_dir/ --smoke

Admission is fail-fast: any artifact in the directory with an
error-severity toadcheck finding aborts the launch with exit status 1
(``fleet admission refused: ...``, naming every offending file), so a
malformed bundle can never ride into a fleet rollout.  Per-model probe
queries reuse each artifact's eval fingerprint probe set, so the parity
check exercises the same inputs the artifact was fingerprinted on.  The
serving window holds the serving alone: the parity check runs after the
last future resolved.  The CLI injects no fault, so a batch served by a
fallback (``--resilience`` with ``fallback`` set) means a primary failed:
the CLI then exits non-zero whatever the parity.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time

import numpy as np

from repro_torch.launch.serve import PARITY_ATOL


def _probe_queries(model, n: int) -> np.ndarray:
    """(n, d) queries from the artifact's own eval-fingerprint probe set."""
    fp = (model.artifact_meta or {}).get("fingerprint") or {}
    n_probe, seed = int(fp.get("n_probe", 32)), int(fp.get("seed", 7))
    if hasattr(model, "probe_inputs"):
        # streaming entries synthesize the probe from their header tables
        probe = model.probe_inputs(n=n_probe, seed=seed)
    else:
        from repro_torch.core.pipeline import probe_inputs

        probe = probe_inputs(model.forest, n=n_probe, seed=seed)
    reps = -(-n // len(probe))  # ceil
    return np.tile(probe, (reps, 1))[:n]


def _print_manifest(manifest: dict) -> None:
    print(f"fleet manifest: {manifest['n_models']} model(s)")
    for mid, row in manifest["models"].items():
        enc = row["encoded_stream_bytes"]
        stream = f" stream={enc:.0f} B" if enc is not None else ""
        print(
            f"  {mid:20s} v{row['version']} format-v{row['format_version']} "
            f"spec={row['spec'] or 'pre-spec':16s} "
            f"trees={row['n_trees']:4d}{stream}"
        )
    dd = manifest["dedup"]
    print(
        f"dedup: {dd['n_tables']} table(s), {dd['n_shared_tables']} shared, "
        f"{dd['dedup_saved_bytes']:.0f} B saved"
    )


class _AdmissionLog(logging.Handler):
    """Collects the registry's ``admitted ...`` lines during one admission."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _admit(args, device, streaming: bool):
    """``ModelRegistry.from_dir`` over ``--models``, its admission lines and
    wall seconds; a refused directory exits 1."""
    from repro_torch.api.artifact import ArtifactError
    from repro_torch.fleet import ModelRegistry

    log = _AdmissionLog()
    logger = logging.getLogger("repro_torch.fleet.registry")
    level = logger.level
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        registry = ModelRegistry.from_dir(args.models, streaming=streaming,
                                          device=device)
    except ArtifactError as e:
        raise SystemExit(f"fleet admission refused: {e}")
    finally:
        logger.removeHandler(log)
        logger.setLevel(level)
    return registry, log.lines, time.perf_counter() - t0


def _labels_differ(got: np.ndarray, ref: np.ndarray, task: str) -> np.ndarray:
    from repro_torch.gbdt.early_exit import predict_label_from_scores

    n = len(got)
    return (predict_label_from_scores(np.asarray(got, np.float64).reshape(n, -1), task)
            != predict_label_from_scores(np.asarray(ref, np.float64).reshape(n, -1), task))


def serve_fleet(args) -> dict:
    """Load every artifact in ``--models`` into a verified registry on
    ``--device`` and either print the planned manifest (``--dry-run``; the
    memory report is returned) or serve routed traffic with per-model
    parity checks (and optional live ``--swap``)."""
    from repro_torch._device import resolve_device
    from repro_torch.api import EarlyExitPolicy, get_backend
    from repro_torch.api.resilience import DeadlineExceeded, Overloaded, resolve_policy
    from repro_torch.fleet import FleetEngine

    policy = resolve_policy(args)
    streaming = bool(getattr(args, "streaming", False))
    device = resolve_device(getattr(args, "device", "cuda"))
    backend = getattr(args, "backend", None)
    if backend in ("auto", None):
        backend = None
    else:
        get_backend(backend)  # fail fast on a typo'd name, before loading
    ee_policy = None
    if getattr(args, "early_exit", None) is not None:
        ee_policy = EarlyExitPolicy(epsilon=args.early_exit)
    registry, admitted, admit_s = _admit(args, device, streaming)
    print(f"admitted {len(registry)} model(s) on {device} in {admit_s:.2f}s "
          f"(toadcheck-verified{', streaming' if streaming else ''})")
    for line in admitted:
        print(f"  {line}")
    _print_manifest(registry.manifest())

    if getattr(args, "dry_run", False):
        report = registry.memory_report()
        print(
            f"planned residency: {report['standalone_total_bytes']:.0f} B "
            f"standalone -> {report['fleet_resident_bytes']:.0f} B fleet "
            f"({report['dedup_saved_bytes']:.0f} B deduped)"
        )
        print(json.dumps(report, indent=2, default=float))
        return report

    n_requests = 256 if args.smoke else args.requests
    engine = FleetEngine(
        registry,
        backend=backend,
        max_hot=getattr(args, "max_hot", 8),
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        policy=policy,
        streaming=streaming,
        early_exit=ee_policy,
    )

    ids = registry.ids()
    if streaming:
        # first-wave partial predictions: answer every streaming model from
        # whatever blocks have landed (no parity — scores may be partial),
        # then wait for completion so the traffic run below checks final
        # scores
        for mid in ids:
            entry = registry.get(mid)
            if not entry.is_streaming:
                continue
            q = _probe_queries(entry.model, 1)
            res = entry.model.scorer.predict(q)
            st = entry.model.streaming_stats()
            print(
                f"  first-wave {mid}: blocks {res.blocks_evaluated}/"
                f"{res.n_blocks} final={res.score_is_final} "
                f"ttfp={st['time_to_first_prediction_ms']:.1f} ms"
            )
        if ee_policy is not None:
            # cold-start + early exit: a FRESH scorer over the same
            # container stops pulling blocks once the partial sums are
            # provably decision-final for the probe batch
            from repro_torch.stream.progressive import ProgressiveScorer
            from repro_torch.stream.reader import open_streaming

            for mid in ids:
                entry = registry.get(mid)
                if not entry.is_streaming:
                    continue
                scorer = ProgressiveScorer(open_streaming(entry.path, device=device))
                q = _probe_queries(entry.model, 4)
                res = scorer.feed_until_confident(q, ee_policy)
                print(
                    f"  cold early-exit {mid}: trees_evaluated "
                    f"{res.trees_evaluated}, blocks {res.blocks_evaluated}/"
                    f"{res.n_blocks}, reason={res.exit_reason}"
                )
        engine.wait_complete()
        print("all streaming entries complete; scores below are final")
    queries = {
        mid: _probe_queries(registry.get(mid).model, n_requests)
        for mid in ids
    }
    rng = np.random.default_rng(0)
    # each client interleaves model ids, so same-model requests from
    # different clients land in the same batches (cross-tenant batching)
    plans = [
        [ids[int(k)] for k in rng.integers(0, len(ids), size=n_requests // args.clients)]
        for _ in range(args.clients)
    ]
    #: (model_id, query index, score) of every served request
    results: list[list] = [[] for _ in plans]

    def client(c: int):
        futs = [(mid, i, engine.submit(mid, queries[mid][i]))
                for i, mid in enumerate(plans[c])]
        for mid, i, fut in futs:
            try:
                results[c].append((mid, i, fut.result()))
            except (Overloaded, DeadlineExceeded):
                # typed, expected outcomes under a resilience policy —
                # parity is checked on whatever completed
                if policy is None:
                    raise
                continue

    with engine:
        engine.warm(*ids)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(len(plans))]
        # the window holds the serving alone: it ends when the last future
        # resolves, and the parity check runs after it
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t1

        # parity after the window and before any swap (every model still
        # serves the version the traffic ran on): one reference call per
        # model over its rows
        errs: list[float] = []
        n_mism = 0
        served = [r for rs in results for r in rs]
        by_model: dict[str, list] = {}
        for mid, i, score in served:
            by_model.setdefault(mid, []).append((i, score))
        for mid, rows in by_model.items():
            entry = registry.get(mid)
            idx = np.array([i for i, _ in rows])
            got = np.stack([s for _, s in rows])
            ref = entry.model.predict(queries[mid][idx], backend="reference")
            if ee_policy is not None and not entry.is_streaming:
                # exited rows carry partial sums — the contract is exact
                # labels, not score parity (streaming entries stay on full
                # evaluation, so they keep the strict score check)
                n_mism += int(np.sum(_labels_differ(got, ref, entry.model.config.task)))
            else:
                errs.append(float(np.abs(got - ref).max()))

        swapped = {}
        for spec in getattr(args, "swap", None) or []:
            mid, _, path = spec.partition("=")
            if not path:
                raise SystemExit(f"--swap expects model_id=path, got {spec!r}")
            before = engine.version(mid)
            entry = engine.swap(mid, path)
            X = _probe_queries(entry.model, 64)
            got = np.stack([f.result() for f in
                            [engine.submit(mid, x) for x in X]])
            ref = entry.model.predict(X, backend="reference")
            if ee_policy is not None and not entry.is_streaming:
                bad = int(np.sum(_labels_differ(got, ref, entry.model.config.task)))
                if bad:
                    raise SystemExit(f"post-swap early-exit label parity: {bad}")
                parity = f"{bad} label mismatch(es)"
            else:
                err = float(np.abs(got - ref).max())
                if not err <= PARITY_ATOL:
                    raise SystemExit(f"post-swap parity {err:.2e} > {PARITY_ATOL:g}")
                parity = f"max|Δ| {err:.2e}"
            if entry.version != before + 1:
                raise SystemExit(f"swap of {mid!r} served v{entry.version}, "
                                 f"not v{before + 1}")
            swapped[mid] = entry.version
            print(f"hot-swapped {mid!r}: v{before} -> v{entry.version} "
                  f"(post-swap parity {parity})")

        # breaker/active views are per *hot* backend: capture before stop()
        # retires them all
        live = engine.stats()

    stats = engine.stats()
    n_checked = len(served)
    max_err = max(errs) if errs else 0.0
    f = stats.fleet
    print(
        f"served {n_checked} routed requests across {len(ids)} models in "
        f"{wall:.2f}s — {n_checked / max(wall, 1e-9):.1f} req/s, "
        f"mean batch {f.mean_batch:.1f}, p50 {f.latency_p50_ms:.2f} ms, "
        f"p95 {f.latency_p95_ms:.2f} ms, {f.n_batches} batches, "
        f"{stats.n_retired} retired backend(s)"
    )
    if ee_policy is not None:
        print(f"early-exit: trees_evaluated mean "
              f"{f.mean_trees_evaluated:.2f} per row over "
              f"{f.n_early_exit_rows} rows "
              f"(exact-label mismatches = {n_mism}/{n_checked})")
    else:
        print(f"parity vs per-model reference: max|Δ| = {max_err:.2e}")
    if policy is not None:
        print(f"resilience: shed={stats.n_shed} "
              f"deadline_expired={stats.n_deadline_expired} "
              f"worker_restarts={stats.n_worker_restarts} "
              f"fallback_batches={f.n_fallback_batches} "
              f"breaker={live.breaker_state} active={live.active_backend}")
    report = registry.memory_report()
    print(
        f"residency: {report['standalone_total_bytes']:.0f} B standalone -> "
        f"{report['fleet_resident_bytes']:.0f} B fleet "
        f"({report['dedup_saved_bytes']:.0f} B deduped across models)"
    )
    n_planned = sum(len(p) for p in plans)
    if policy is None and n_checked != n_planned:
        raise SystemExit(f"served {n_checked} of {n_planned} requests")
    if f.n_fallback_batches:
        raise SystemExit(
            f"{f.n_fallback_batches} batch(es) served by a fallback across the "
            f"fleet: a primary backend failed with no fault injected")
    if n_mism:
        raise SystemExit(f"{n_mism} early-exited request(s) changed their label")
    if not max_err <= PARITY_ATOL:
        raise SystemExit(f"parity {max_err:.2e} exceeds {PARITY_ATOL:g}")
    if f.n_requests < n_checked:
        raise SystemExit(f"the engines counted {f.n_requests} requests, "
                         f"{n_checked} were served")
    return {
        "stats": stats.as_dict(),
        "memory": report,
        "max_err": max_err,
        "swapped": swapped,
        "label_mismatches": n_mism if ee_policy is not None else None,
        "n_served": n_checked,
        "wall_s": wall,
        "req_per_s": n_checked / max(wall, 1e-9),
        "admitted": admitted,
        "admission_s": admit_s,
    }


def add_fleet_args(ap: argparse.ArgumentParser) -> None:
    """Fleet flags, shared with the serve CLI's --arch toad-fleet path."""
    ap.add_argument("--models", default=None,
                    help="directory of .toad/.toadpack artifacts; "
                         "model_id = file stem")
    ap.add_argument("--dry-run", action="store_true",
                    help="verify + print the planned fleet manifest and "
                         "residency report without serving")
    ap.add_argument("--max-hot", type=int, default=8,
                    help="LRU size of warm per-model backends")
    ap.add_argument("--swap", action="append", default=None,
                    metavar="MODEL_ID=PATH",
                    help="after the traffic run, hot-swap MODEL_ID to the "
                         "artifact at PATH and assert the new version serves")
    ap.add_argument("--streaming", action="store_true",
                    help="progressive cold-start: serve .toadpack entries "
                         "from their first tree block while the rest stream "
                         "in")
    ap.add_argument("--early-exit", type=float, default=None,
                    metavar="EPSILON",
                    help="adaptive early exit: stop evaluating a row once "
                         "its decision is provably final within EPSILON "
                         "margin slack (0 is already sound; inf never "
                         "exits); parity switches to exact-label equality")


def main(argv=None) -> dict:
    from repro_torch.api.resilience import add_resilience_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fleet_args(ap)
    add_resilience_args(ap)
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
    args = ap.parse_args(argv)
    if not args.models:
        ap.error("--models is required")
    return serve_fleet(args)


if __name__ == "__main__":
    main()
