"""toadcheck of the port: verify ``.toad`` artifacts and lint the port's
sources from the command line (``tools/toadcheck.py``'s counterpart).

    PYTHONPATH=src python -m repro_torch.launch.toadcheck          # lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.launch.toadcheck model.toad
    PYTHONPATH=src python -m repro_torch.launch.toadcheck model.toadpack
    PYTHONPATH=src python -m repro_torch.launch.toadcheck --format json src/repro_torch a.toad
    PYTHONPATH=src python -m repro_torch.launch.toadcheck --write-baseline \\
        --justification "why it is deliberate" src/repro_torch

Targets are dispatched by kind: a directory or ``.py`` file goes to the
code lint (``repro_torch.analysis.lint``, codes ``TOAD2xx``; the port's
tests under ``--tests-dir`` are searched for backend names and held to the
``gpu`` capability gate); anything else is verified structurally
(``repro_torch.analysis.verify``: ``TOAD0xx`` for the stream, ``TOAD1xx``
for the bundle, ``TOAD11x`` for a ``.toadpack`` container, told apart by
its magic bytes and checked deep), without decoding-to-predict and without
a card.

Exit codes: 0 = no non-baselined errors (warnings are reported, never
fatal); 1 = error findings; 2 = usage error (a missing target, or
``--write-baseline`` without ``--justification``).  The port's
grandfathered lint findings live in ``tools/toadcheck_torch_baseline.json``
(``--baseline`` to choose another file, ``--no-baseline`` to report them
too); every entry carries a justification and is keyed by content hash.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import (
    Baseline,
    errors,
    format_diagnostics,
    lint_paths,
    verify_artifact,
)

_REPO = Path(__file__).resolve().parents[3]
DEFAULT_BASELINE = _REPO / "tools" / "toadcheck_torch_baseline.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="toadcheck", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("targets", nargs="*", default=[str(_REPO / "src" / "repro_torch")],
                    help="directories/.py files to lint and/or .toad artifacts and "
                         ".toadpack containers to verify (default: src/repro_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="grandfathered-findings file (JSON)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report baselined findings too")
    ap.add_argument("--write-baseline", action="store_true",
                    help="add the current non-baselined findings to the "
                         "baseline file (requires --justification)")
    ap.add_argument("--justification", default="",
                    help="justification recorded with --write-baseline")
    ap.add_argument("--tests-dir", default=str(_REPO / "tests"),
                    help="tests directory for TOAD206 and the gpu tests of TOAD204")
    args = ap.parse_args(argv)

    lint_targets, artifact_targets = [], []
    for t in args.targets:
        p = Path(t)
        if not p.exists():
            print(f"toadcheck: no such target: {t}", file=sys.stderr)
            return 2
        (lint_targets if p.is_dir() or p.suffix == ".py"
         else artifact_targets).append(str(p))

    diags = []
    if lint_targets:
        diags.extend(lint_paths(lint_targets, tests_dir=args.tests_dir))
    for a in artifact_targets:
        diags.extend(verify_artifact(a))

    baseline = Baseline()
    if not args.no_baseline and Path(args.baseline).exists():
        baseline = Baseline.load(args.baseline)

    if args.write_baseline:
        fresh = baseline.apply(diags)
        if fresh and not args.justification:
            print("toadcheck: --write-baseline needs --justification "
                  "(every grandfathered finding records why it is ok)",
                  file=sys.stderr)
            return 2
        for d in fresh:
            baseline.entries[d.fingerprint()] = args.justification
        baseline.save(args.baseline)
        print(f"baseline: {len(fresh)} finding(s) added to {args.baseline}")
        return 0

    reported = baseline.apply(diags)
    suppressed = len(diags) - len(reported)
    print(format_diagnostics(reported, args.format))
    fatal = errors(reported)
    if args.format == "text":
        tail = f" ({suppressed} baselined)" if suppressed else ""
        print(f"toadcheck: {len(fatal)} error(s), "
              f"{len(reported) - len(fatal)} warning(s)/info{tail}")
    return 1 if fatal else 0


if __name__ == "__main__":
    raise SystemExit(main())
