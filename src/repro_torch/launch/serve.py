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
    PYTHONPATH=src python -m repro_torch.launch.serve --arch toad-gbdt \
        --model model.toad --deadline-ms 1000 --max-queue 4096

With ``--model`` the artifact is admitted through ``load_checked``
(toadcheck, then the load and its eval-fingerprint probe): a bundle with an
error finding is refused and the CLI exits non-zero.  The requests are the
artifact's own fingerprint probe rows.  Without it the reduced ``toad_gbdt`` workload
is trained in-process on ``--device`` (synthetic rows drawn from a seed),
compressed, and served on its training rows.  Either way every served
score is checked against the ``reference`` backend (<= 1e-5).  With
``--early-exit EPSILON`` the engine serves through an
``EarlyExitPredictor`` (the early-exit kernel on the ``cuda`` backend), so
exited rows carry partial sums: the check is then exact labels against the
``reference`` backend's, and the mean trees evaluated is printed.

``--deadline-ms``, ``--max-queue`` and ``--resilience SPEC.json`` give the
engine a :class:`~repro_torch.api.resilience.ResiliencePolicy` (bounded
queue, deadlines, retries and breakers).  The ``cuda -> packed ->
reference`` fallback chain, on the same device, comes only from a
``--resilience`` spec with ``fallback`` set.  Shed and expired requests are
then expected outcomes: the parity check covers the served ones, the
``resilience:`` line prints the counters, and every request must resolve
(served + shed + expired = requests).  The CLI injects no fault, so a batch
served by a fallback means the primary failed: the CLI then exits non-zero
whatever the parity.  Without these flags there is no policy and no
fallback.

``--arch toad-fleet --models DIR`` serves a directory of artifacts behind
the fleet router instead (:mod:`repro_torch.launch.fleet`: ``--dry-run``,
``--max-hot``, ``--swap``, ``--streaming``, ``--early-exit``, the same
resilience flags)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch toad-fleet \
        --models fleet_dir/ --device cpu --smoke

The LM path (every LM architecture: the transformer family, RWKV-6, the
RG-LRU hybrid, whisper) runs a batched prefill, then the decode loop, with
the tokens kept on the device and read back once at the end; random
weights from seed ``LM_SEED``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --reduced --device cpu --batch 2 --prompt-len 16 --decode-steps 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --batch 4 --prompt-len 512 --decode-steps 32     # full width, the card

A VLM's prompt starts with ``prompt_len // frontend_len_div`` patch
embeddings (ones) and whisper's batch holds ``prompt_len //
frontend_len_div`` encoder frames (ones) beside its ``prompt_len`` tokens,
as the JAX serve CLI builds them.  Only an attention cache over the prompt
grows to prompt + steps; the recurrent state and the ring buffer do not
depend on it.  It prints prefill ms, decode ms/step (the median after the
first step), tok/s beside the device's name, the peak memory on a card, a
MoE's dropped-slot share, and a sample.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import time

import numpy as np

GBDT_ARCHS = ("toad-gbdt", "toad_gbdt")
FLEET_ARCHS = ("toad-fleet", "toad_fleet")
PARITY_ATOL = 1e-5
LM_SEED = 0  # the LM path's random weights (no weights exist to load)


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
    print(f"toadcheck: ok ({len(loaded.warnings)} warning(s))")
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


class _StepClock:
    """Marks between steps without a host sync: CUDA events on a card (read
    once at the end), the host clock on the CPU, where ops are synchronous."""

    def __init__(self, dev):
        import torch

        self.cuda = dev.type == "cuda"
        self.marks = []
        self._torch = torch

    def mark(self) -> None:
        if self.cuda:
            ev = self._torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            self._torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def lm_layout(cfg, S: int) -> tuple:
    """How a prompt of S positions splits for ``cfg``'s family: (the name of
    its side input, ``"embeds"`` for a VLM's patch embeddings, ``"frames"``
    for an encoder-decoder's encoder frames, else None; that input's
    length; the number of text tokens), as the JAX serve CLI splits it."""
    if cfg.family == "vlm":
        pe = S // cfg.frontend_len_div
        return "embeds", pe, S - pe
    if cfg.family == "encdec":
        return "frames", S // cfg.frontend_len_div, S
    return None, 0, S


def serve_lm(args) -> dict:
    """Batched prefill + decode loop over the port's LM stack, on
    ``--device``.  Returns the timings, the side input it built (``side``,
    on the device) and, read back at the end, the prompt, the decoded
    tokens and the first decode step's logits."""
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import count_params, get_model

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    model = get_model(cfg, dev)
    B, S, steps = args.batch, args.prompt_len, args.decode_steps
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    n_params = count_params(model.param_shapes())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(LM_SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED + 1)
    side, n_side, n_text = lm_layout(cfg, S)
    batch = {} if side is None else {
        side: torch.ones((B, n_side, cfg.d_model), dtype=torch.bfloat16, device=dev)}
    batch["tokens"] = torch.randint(0, cfg.vocab, (B, n_text), generator=gen, device=dev)
    moe = {"prefill": {}, "decode": {}} if cfg.family == "moe" else None
    clock = _StepClock(dev)
    clock.mark()
    logits, cache = model.prefill(params, batch, max_seq=S + steps,
                                  stats=None if moe is None else moe["prefill"])
    clock.mark()
    tok = torch.argmax(logits[:, : cfg.vocab], -1)
    out, first = [tok], None
    for _ in range(steps):
        logits, cache = model.decode_step(params, cache, tok,
                                          stats=None if moe is None else moe["decode"])
        first = logits if first is None else first
        tok = torch.argmax(logits[:, : cfg.vocab], -1)
        out.append(tok)
        clock.mark()
    ms = clock.intervals_ms()
    toks = torch.stack(out, dim=1).cpu().numpy()  # the one read-back of tokens
    prefill_ms, decode_ms = ms[0], ms[1:]
    steady = decode_ms[1:] or decode_ms
    median = float(np.median(steady)) if steady else float("nan")
    tok_s = B * len(decode_ms) / (sum(decode_ms) / 1e3) if decode_ms else float("nan")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    drop = None
    if moe is not None:
        drop = {k: (1.0 - float(v["kept"]) / v["slots"]) if v else None
                for k, v in moe.items()}
    print(f"{cfg.name}{' (reduced)' if args.reduced else ''}: {n_params:,} parameters "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}), batch {B}, prompt {S}")
    print(f"prefill {prefill_ms:.3f} ms; decoded {steps} steps x batch {B}: "
          f"{median:.3f} ms/step (median after the first), {tok_s:.1f} tok/s on {card}"
          + (f"; peak memory_allocated {peak / 2**30:.2f} GiB" if peak is not None else ""))
    if drop is not None:
        print(f"moe: dropped routed slots {drop['prefill']:.4f} at prefill, "
              f"{drop['decode'] if drop['decode'] is not None else float('nan'):.4f} "
              f"at decode")
    print("sample:", toks[0].tolist())
    return {"arch": cfg.name, "device": str(dev), "card": card, "n_params": n_params,
            "batch": B, "prompt_len": S, "decode_steps": steps,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms, "decode_ms_median": median,
            "tok_per_s": tok_s, "peak_bytes": peak, "moe_drop": drop,
            "side": {k: v for k, v in batch.items() if k != "tokens"},
            "prompt": batch["tokens"].cpu().numpy(), "tokens": toks,
            "first_logits": first.float().cpu().numpy() if first is not None else None}


def serve_gbdt(args) -> dict:
    """Serve the artifact's probe rows (or the in-process model's training
    rows) through the engine; returns the engine stats plus the parity
    error and the backend that served."""
    from repro_torch._device import resolve_device
    from repro_torch.api import (
        DeadlineExceeded,
        EarlyExitPolicy,
        GBDTEngine,
        Overloaded,
        available_backends,
        get_backend,
    )
    from repro_torch.api.resilience import resolve_policy
    from repro_torch.gbdt.early_exit import predict_label_from_scores

    ee_policy = None
    if args.early_exit is not None:
        ee_policy = EarlyExitPolicy(epsilon=args.early_exit)
    policy = resolve_policy(args)
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
        policy=policy, early_exit=ee_policy,
    )
    rng = np.random.default_rng(0)
    queries = X[rng.integers(0, X.shape[0], size=n_requests)]
    scores = np.zeros((n_requests, model.forest.n_ensembles), np.float32)
    served = np.zeros(n_requests, bool)

    def client(lo: int, hi: int) -> None:
        futs = [engine.submit(queries[i]) for i in range(lo, hi)]
        for i, f in zip(range(lo, hi), futs):
            # under a resilience policy, shed (Overloaded) and expired
            # (DeadlineExceeded) requests are expected typed outcomes:
            # parity is checked on whatever completed
            try:
                scores[i] = f.result()
            except (Overloaded, DeadlineExceeded):
                if policy is None:
                    raise
                continue
            served[i] = True

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
    scores, ref_rows = scores[served], queries[served]
    ref = model.predict(ref_rows, backend="reference")
    max_err = float(np.abs(scores - ref).max()) if len(ref_rows) else 0.0
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
    if policy is not None:
        print(f"resilience: shed={s.n_shed} "
              f"deadline_expired={s.n_deadline_expired} "
              f"worker_restarts={s.n_worker_restarts} "
              f"fallback_batches={s.n_fallback_batches} "
              f"breaker={s.breaker_state} active={s.active_backend}")
    if args.scores_out:
        np.savez(args.scores_out, queries=ref_rows, scores=scores)
    if policy is not None:
        # every submitted request resolved: with a score, a shed or an
        # expiry, the zero-stranded-futures contract end to end
        if s.n_requests + s.n_shed + s.n_deadline_expired != n_requests:
            raise SystemExit(
                f"{s.n_requests} served + {s.n_shed} shed + "
                f"{s.n_deadline_expired} expired != {n_requests} requests")
        if s.n_fallback_batches:
            raise SystemExit(
                f"{s.n_fallback_batches} batch(es) served by a fallback: the "
                f"{engine.backend} backend failed with no fault injected")
    elif s.n_requests != n_requests:
        raise SystemExit(f"served {s.n_requests} of {n_requests} requests")
    if mismatches:
        raise SystemExit(f"{mismatches} early-exited request(s) changed their label")
    if ee_policy is None and not max_err <= PARITY_ATOL:
        raise SystemExit(f"parity {max_err:.2e} exceeds {PARITY_ATOL:g}")
    return {**s.as_dict(), "req_per_s": s.n_requests / wall,
            "max_abs_err": max_err, "label_mismatches": mismatches,
            "backend": engine.backend,
            "policy": policy.to_dict() if policy is not None else None}


def main(argv=None) -> dict:
    from repro_torch.api.resilience import add_resilience_args
    from repro_torch.launch.fleet import add_fleet_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="toad-gbdt | toad-fleet | an LM architecture (qwen3-4b, ...)")
    ap.add_argument("--reduced", action="store_true",
                    help="LM: the architecture's same-family miniature")
    ap.add_argument("--batch", type=int, default=4, help="LM: sequences a batch")
    ap.add_argument("--prompt-len", type=int, default=32, help="LM: prompt tokens")
    ap.add_argument("--decode-steps", type=int, default=16, help="LM: decoded tokens")
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
    ap.add_argument("--scores-out", default=None,
                    help="write the served rows and their scores to this .npz")
    # the fleet (--arch toad-fleet): --models dir/, --dry-run, --max-hot,
    # --swap, --streaming; and --early-exit EPSILON for both archs
    add_fleet_args(ap)
    # serving resilience: --deadline-ms, --max-queue, --resilience spec.json
    add_resilience_args(ap)
    args = ap.parse_args(argv)
    if args.arch in FLEET_ARCHS:
        from repro_torch.launch.fleet import serve_fleet

        if not args.models:
            ap.error("--arch toad-fleet requires --models dir/")
        return serve_fleet(args)
    from repro_torch.configs import ARCHS

    if args.arch in ARCHS:
        return serve_lm(args)
    if args.arch not in GBDT_ARCHS:
        ap.error(f"unknown --arch {args.arch!r}: toad-gbdt, toad-fleet or one of "
                 f"{', '.join(ARCHS)}")
    return serve_gbdt(args)


if __name__ == "__main__":
    main()
