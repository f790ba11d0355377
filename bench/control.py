#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from.

    python3 bench/control.py --workload <cell> --seeds a,b,... [--seconds S]
        [--control-seeds a,b] [--faults x,y --fault-seeds a,b]

Every reading is one run of the harness's own ``run_cell`` with a short
window (``--seconds``; 0 runs one fit, or one request), and the numbers are
its own ``checks``.  For each of ``--seeds`` the program as it is: the
*lower* readings.  For each of ``--control-seeds`` the control of
``faults.CONTROLS`` planted in the program's place, one precision step
below the configuration's float32; for each of ``--fault-seeds`` each fault
of ``faults.FAULTS`` named in ``--faults``: the *upper* readings.

Prints one JSON line per run, then the largest program reading and the
smallest reading of each other side, per number.  The benchmark's runs do
not run this; it runs on the card (``--device cpu`` for the tests' small
sizes).
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def readings(name, seed, seconds, device, plant=None, overrides=None) -> dict:
    """One run of the cell with ``plant`` (a context manager, or None)
    around it; the compared numbers, keyed by name, and ``correct``."""
    from bench.core import harness

    with plant() if plant else contextlib.nullcontext():
        result, checks = harness.run_cell(name, seed, seconds, False, device,
                                          time.perf_counter(), overrides)
    return dict({k: v for k, v, _ in checks}, correct=result["correct"],
                attempted=result["attempted"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="faults of bench/faults.py to plant")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}",
                    help="JSON merged into the cell's configuration and traffic (the tests' "
                         "small sizes)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.core import spec
    from bench.faults import CONTROLS, FAULTS

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    overrides = json.loads(args.overrides)
    cell = spec.cell(args.workload, overrides)
    runner = cell["traffic"]["runner"]
    runs = [("program", None, s) for s in _seeds(args.seeds)]
    runs += [("control", CONTROLS[runner], s) for s in _seeds(args.control_seeds)]
    runs += [(f"fault:{f}", FAULTS[runner][f], s)
             for f in args.faults.split(",") if f for s in _seeds(args.fault_seeds)]
    rows = []
    for side, plant, seed in runs:
        row = dict(side=side, seed=seed,
                   **readings(args.workload, seed, args.seconds, args.device, plant, overrides))
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    summary = {}
    for k, limit in cell["traffic"]["checks"].items():
        by_side: dict[str, list[float]] = {}
        for r in rows:
            by_side.setdefault(r["side"], []).append(r[k])
        summary[k] = dict(limit=limit, **{
            side: max(v) if side == "program" else min(v) for side, v in by_side.items()})
    print(json.dumps(dict(summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
