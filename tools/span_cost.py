#!/usr/bin/env python3
"""What the port's spans (``repro_torch.tracing``) cost when they record,
what they read, and that they change no result, on the card at a
benchmark cell's size.

    python3 tools/span_cost.py --seed 4700000001 --pairs 8

Sets up ``toad_gbdt-score`` and ``toad_gbdt-fit`` as ``bench/run.py`` does
(the same inputs from the seed), then, for each:

* ``--pairs`` pairs of untraced runs, one with spans off and one inside
  ``tracing.collect()``, in turns (off first in even pairs, on first in
  odd ones): whole fits of the same penalties, timed from the call to the
  synchronise, or cycles of the cell's plan (every request size once,
  scores read back); each result is compared bit for bit with the first;
  the spans of the ``on`` runs give each step's self time, untraced;
* one more run under ``torch.profiler`` as the benchmark's traced stretch
  runs it (the fit with device activity only, a cycle with host and
  device activity): each step's self time traced, the share of the root
  spans that their children cover, the root spans counted, and each span
  against its profiler range where the profile kept one.

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _same(a, b) -> bool:
    import torch

    a, b = (x if isinstance(x, dict) else vars(x) for x in (a, b))
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(b[k], torch.Tensor) else a[k] == b[k] for k in b)


def _quartiles(values: list[float]) -> list[float]:
    return [float(q) for q in statistics.quantiles(values, n=4)]


def _self_ms(spans, per: float) -> dict[str, float]:
    """Summed self time by span name, in ms over ``per``."""
    from repro_torch import tracing

    return {k: v * 1e-6 / per for k, v in sorted(tracing.self_ns_by_name(spans).items())}


def _pairs(run, pairs: int, same) -> dict:
    """``pairs`` pairs of ``run()`` with spans off and on, in turns; returns
    the host seconds of each side, the spans of the ``on`` runs, and
    whether every result equals the first (by ``same``)."""
    from repro_torch import tracing

    walls = {"off": [], "on": []}
    on_spans, first, identical = [], None, True
    for i in range(pairs):
        for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
            t0 = time.perf_counter()
            if side == "on":
                with tracing.collect() as spans:
                    out = run()
                on_spans.append(spans)
            else:
                out = run()
            walls[side].append(time.perf_counter() - t0)
            if first is None:
                first = out
            identical &= bool(same(out, first))
    tracing.clear()
    return dict(walls=walls, spans=on_spans, identical=identical)


def _profiled(run, device, host: bool):
    """``run()`` under ``torch.profiler`` (host activity when ``host``, device
    activity on the card); returns the spans and the profile's host ranges
    by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench.core.trace import sync
    from repro_torch import tracing

    on_card = device.type == "cuda"
    activities = (([ProfilerActivity.CPU] if host or not on_card else [])
                  + ([ProfilerActivity.CUDA] if on_card else []))
    tracing.clear()
    with profile(activities=activities) as prof:
        run()
        sync(device)
    spans = tracing.recorded()
    tracing.clear()
    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            ranges.setdefault(e.name(), []).append(e)
    return spans, ranges


def _traced(spans, ranges, root: str, per: float) -> dict:
    """What a profiled run's spans read: self time by name over ``per``, the
    ``root`` spans and the share of them their children cover, and the
    largest distance of a span's ends from its range's."""
    from repro_torch import tracing

    own = tracing.self_ns(spans)
    roots = [k for k, s in enumerate(spans) if s.name == root and s.parent < 0]
    root_ns = sum(spans[k].duration_ns for k in roots)
    gaps = []
    for name in {s.name for s in spans} & set(ranges):
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted(ranges[name], key=lambda e: e.start_ns())
        gaps += [max(abs(s.start_ns - e.start_ns()),
                     abs(s.end_ns - e.start_ns() - e.duration_ns()))
                 for s, e in zip(mine, theirs)]
    return dict(self_ms=_self_ms(spans, per), roots=len(roots),
                root_ms=root_ns * 1e-6 / per,
                children_cover=1.0 - sum(own[k] for k in roots) / root_ns if root_ns else None,
                ranges_kept=len(gaps), max_gap_us=max(gaps) / 1e3 if gaps else None)


def fits(device, seed: int, pairs: int, overrides: dict | None = None) -> dict:
    from bench.core import fit_sweep, spec
    from bench.core.trace import sync

    cell = spec.cell("toad_gbdt-fit", overrides)
    state = fit_sweep.setup(cell, seed, device)
    pen = state["order"][0]
    rounds = state["base"].n_rounds

    def run():
        sync(device)
        model = fit_sweep._fit(state, pen)
        sync(device)
        return model.forest, model.history, model.aux

    got = _pairs(run, pairs, lambda a, b: all(_same(x, y) for x, y in zip(a, b)))
    ms = {k: [w / rounds * 1e3 for w in v] for k, v in got["walls"].items()}
    ratio = [on / off for on, off in zip(got["walls"]["on"], got["walls"]["off"])]
    untraced = [_self_ms(s, rounds) for s in got["spans"]]
    traced = _traced(*_profiled(run, device, host=False), "train", rounds)
    return dict(penalties=list(pen), ms_a_round=ms,
                median_ms={k: statistics.median(v) for k, v in ms.items()},
                quartiles_ms={k: _quartiles(v) for k, v in ms.items()},
                on_over_off_median=statistics.median(ratio),
                on_over_off_quartiles=_quartiles(ratio),
                spans_a_fit=sorted({len(s) for s in got["spans"]}),
                untraced_self_ms_a_round={k: statistics.median(u[k] for u in untraced)
                                          for k in untraced[0]},
                traced_a_round=traced, bit_identical=got["identical"])


def scoring(device, seed: int, pairs: int, overrides: dict | None = None) -> dict:
    import torch

    from bench.core import score_loop, spec

    cell = spec.cell("toad_gbdt-score", overrides)
    state = score_loop.setup(cell, seed, device)
    predict, pool = state["predict"], state["pool"]
    K = len(state["sizes"])
    reqs = [(int(o), int(n)) for n, o in zip(state["plan_n"][:K], state["plan_off"][:K])]

    def run():
        return [predict(pool[o:o + n]).cpu() for o, n in reqs]

    got = _pairs(run, pairs, lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)))
    ms = {k: [w / K * 1e3 for w in v] for k, v in got["walls"].items()}
    untraced = [_self_ms(s, K) for s in got["spans"]]
    traced = _traced(*_profiled(run, device, host=True), "predict", K)
    return dict(requests_a_cycle=K, ms_a_request=ms,
                median_ms={k: statistics.median(v) for k, v in ms.items()},
                spans_a_request=sorted({len(s) / K for s in got["spans"]}),
                untraced_self_ms_a_request={k: statistics.median(u[k] for u in untraced)
                                            for k in untraced[0]},
                traced_a_request=traced, bit_identical=got["identical"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the measurement) or cpu (a rehearsal at small --overrides)")
    ap.add_argument("--overrides", default="{}",
                    help="JSON: cell name -> overrides of its configuration and traffic")
    args = ap.parse_args(argv)
    import torch

    overrides = json.loads(args.overrides)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("span_cost: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    out = dict(card=card, seed=args.seed, pairs=args.pairs)
    out["scoring"] = scoring(device, args.seed, args.pairs, overrides.get("toad_gbdt-score"))
    print(json.dumps(out["scoring"]), file=sys.stderr, flush=True)
    out["fit"] = fits(device, args.seed, args.pairs, overrides.get("toad_gbdt-fit"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
