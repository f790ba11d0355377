#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: makes its
inputs from the seed on the card, warms up, measures for ``--seconds``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its per-layer
metrics, from a profiled stretch after the window), checks what the window
produced against the plain reference in ``bench/reference``, and prints one
JSON line.  Without a CUDA card it exits with 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import gc  # noqa: E402

# no cyclic collection while set-up builds its objects: the harness
# collects once and freezes what set-up made before the window
# (``harness.run_cell``), and the window runs with the collector on
gc.disable()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout (the
    # port's own CUDA libraries go to build/torch_kernels/ there)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import json

    import torch

    t_import = time.perf_counter()
    cells = {w["name"]: w for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
    if args.workload not in cells:
        print(f"bench: unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); the benchmark measures the card "
              "only", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)  # the CUDA context
    from bench.core import harness

    phases = {"imports": t_import - T0, "CUDA context": time.perf_counter() - t_import}
    return harness.main(args, device, T0, phases)


if __name__ == "__main__":
    sys.exit(main())
