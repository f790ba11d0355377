"""Run every dry-run cell of the port as an isolated subprocess (resumable;
``repro.launch.sweep``).

    PYTHONPATH=src python -m repro_torch.launch.sweep --results build/dryrun \\
        --only-mesh single

Order: for each mesh (single-pod, then multi-pod) every arch × shape, then
the toad_gbdt cell: 2 × (10 × 4 + 1) = 82 cells.  An existing ``OK`` or
``SKIP`` JSON is skipped, so the sweep can be re-run after fixes and only
failed or missing cells recompute; a cell that fails, or outlives
``--timeout``, gets a ``FAIL`` record.  The cells run one after another,
as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def cells():
    from repro_torch.configs import ARCHS

    for mesh in ("single", "multi"):
        for arch in ARCHS:
            for shape in SHAPE_NAMES:
                yield arch, shape, mesh
        yield "toad_gbdt", "default", mesh


def out_path(results: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(results, f"dryrun_{arch}_{shape}_{mesh}.json".replace("/", "_"))


def _done(out: str) -> str | None:
    """The status of an existing record that needs no rerun, else None."""
    try:
        with open(out) as f:
            status = json.load(f).get("status")
    except (OSError, ValueError):
        return None
    return status if status in ("OK", "SKIP") else None


def run_cell(arch: str, shape: str, mesh: str, out: str, timeout: float) -> str:
    """One cell in its own process; writes a ``FAIL`` record for a crash or
    a timeout.  Returns the status."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", out]
    env = {**os.environ, "PYTHONPATH": os.path.normpath(src)}
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        error, status = f"timeout after {timeout} s", "TIMEOUT"
    else:
        if p.returncode == 0:
            return _done(out) or "OK"
        if os.path.exists(out):  # the dry run wrote its own FAIL record
            return "FAIL"
        error, status = (p.stderr or "")[-2000:], "FAIL"
    with open(out, "w") as f:
        json.dump({"status": "FAIL", "arch": arch, "shape": shape, "mesh": mesh,
                   "error": error}, f, indent=2)
    return status


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", default="results")
    ap.add_argument("--timeout", type=int, default=1500)
    ap.add_argument("--only-mesh", default=None, choices=["single", "multi"])
    args = ap.parse_args(argv)
    os.makedirs(args.results, exist_ok=True)

    for arch, shape, mesh in cells():
        if args.only_mesh and mesh != args.only_mesh:
            continue
        out = out_path(args.results, arch, shape, mesh)
        status = _done(out)
        if status:
            print(f"[skip-existing] {out} ({status})", flush=True)
            continue
        t0 = time.time()
        print(f"[run] {arch} {shape} {mesh}", flush=True)
        status = run_cell(arch, shape, mesh, out, args.timeout)
        print(f"[done] {arch} {shape} {mesh}: {status} ({time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
