"""toadcheck of the port: verify ``.toad`` artifacts from the command line.

    PYTHONPATH=src python -m repro_torch.launch.toadcheck model.toad
    PYTHONPATH=src python -m repro_torch.launch.toadcheck --format json a.toad b.toad

Each target is verified structurally (``repro_torch.analysis.verify``:
codes ``TOAD0xx`` for the stream, ``TOAD1xx`` for the bundle), without
decoding-to-predict and without a card.  Exit codes: 0 = no errors
(warnings are reported, never fatal); 1 = error findings; 2 = usage error
(a missing target, or a target the port does not check yet: the code lint
of ``.py`` files and directories (TOAD2xx) waits for the lint's port, and
the ``.toadpack`` streaming container for the streaming slice).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import errors, format_diagnostics, verify_artifact


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="toadcheck", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("targets", nargs="+", help=".toad artifacts to verify")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    for t in args.targets:
        p = Path(t)
        if not p.exists():
            print(f"toadcheck: no such target: {t}", file=sys.stderr)
            return 2
        if p.is_dir() or p.suffix == ".py":
            print(f"toadcheck: {t}: the code lint (TOAD2xx) is not in the port "
                  "yet (ROADMAP queue A, item 21); this command verifies "
                  ".toad artifacts", file=sys.stderr)
            return 2

    diags = []
    for t in args.targets:
        try:
            diags.extend(verify_artifact(t))
        except NotImplementedError as e:
            print(f"toadcheck: {e}", file=sys.stderr)
            return 2
    print(format_diagnostics(diags, args.format))
    fatal = errors(diags)
    if args.format == "text":
        print(f"toadcheck: {len(fatal)} error(s), "
              f"{len(diags) - len(fatal)} warning(s)/info")
    return 1 if fatal else 0


if __name__ == "__main__":
    raise SystemExit(main())
