"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the reference's check, and the result line.

``run_cell`` takes the device as an argument so that the tests can drive a
whole run on the CPU at a small size; ``bench/run.py`` refuses to run
without the card, and a CPU run reports no device metric."""

from __future__ import annotations

import gc
import json
import math
import sys
import time

import torch

from bench.core import spec

#: top-level module names that no run may hold once its window has closed:
#: JAX, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _peak_bytes(device) -> int:
    dev = torch.device(device)
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def _device_info(device, peak: int, trace_rec: dict | None) -> dict:
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    info = dict(platform="gpu" if dev.type == "cuda" else "cpu", kind=kind, count=1,
                memory_peak_bytes=peak)
    if trace_rec is not None and trace_rec.get("trace"):
        info.update(busy_s=trace_rec["trace"]["busy_s"],
                    window_s=trace_rec["trace"]["window_s"])
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             overrides: dict | None = None,
             phases: dict | None = None) -> tuple[dict, list[tuple[str, float, float]]]:
    """Run the cell ``name``; returns the result object and the compared
    numbers as ``(name, value, limit)``.  ``phases``: seconds of set-up
    spent before this call, by name, for the log."""
    phases = dict(phases or {})
    cell = spec.cell(name, overrides)
    runner = spec.runner(cell["traffic"])
    state = runner.setup(cell, seed, device)
    phases.update(state.pop("phases", {}))
    # set-up's objects leave the collector's view: a collection in the
    # window scans only what the window made
    t_gc = time.perf_counter()
    gc.collect()
    gc.freeze()
    gc.enable()
    phases["collect and freeze"] = time.perf_counter() - t_gc
    setup_s = time.perf_counter() - t0
    phases["rest"] = setup_s - sum(phases.values())
    t_w = time.perf_counter()
    done = runner.window(state, seconds)
    t_t = time.perf_counter()
    peak = _peak_bytes(device)  # before the traced stretch and the reference
    rec = runner.trace(state, done) if trace else None
    device_info = _device_info(device, peak, rec)
    t_c = time.perf_counter()
    numbers = runner.check(state, done, cell, seed)
    gc.unfreeze()
    print(f"[bench] {name} seed {seed}: set-up {setup_s:.2f} s, window {t_t - t_w:.2f} s, "
          f"traced stretch {t_c - t_t:.2f} s, reference {time.perf_counter() - t_c:.2f} s; "
          "set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()),
          file=sys.stderr)
    if rec is not None and rec.get("untraced_wall_s"):
        print(f"[bench] traced work {rec['trace_wall_s']:.4f} s, the same untraced "
              f"{rec['untraced_wall_s']:.4f} s", file=sys.stderr)
    limits = cell["traffic"]["checks"]
    checks = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    correct = all(v <= lim for _, v, lim in checks) and all(math.isfinite(v) for _, v, _ in checks)
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = spec.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(done["end_to_end"], setup_s=setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = dict(correct=correct, attempted=done["attempted"], failed=done["failed"],
                  metrics=metrics, device=device_info)
    if rec is not None and rec.get("trace"):
        result["breakdown"] = rec["trace"]["breakdown"]
    if done.get("note"):
        print(f"[bench] {done['note']}", file=sys.stderr)
    extra = {k: v for k, v in numbers.items() if k not in limits}
    if extra:
        print(f"[bench] not compared: {json.dumps(extra)}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks


def main(args, device, t0: float, phases: dict | None = None) -> int:
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device, t0, phases=phases)
    found = forbidden_modules()
    if found:
        print(f"[bench] the run loaded {', '.join(found)}: it must hold no JAX and "
              "nothing of the JAX package", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    return 0
