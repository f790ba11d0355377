"""The dry-run sweep's records as a markdown table.

    PYTHONPATH=src python tools/dryrun_table.py --results DIR [--mesh single]

Reads ``dryrun_*_{mesh}.json`` from a ``repro_torch.launch.sweep`` run and
prints one row an arch, one column a shape; a cell holds the argument
bytes a device on the production mesh, the FLOPs a device, the peak live
bytes (the whole step's, or one device's, marked "a device", where the
cell traces the meshed step: every family's decode cells),
the step's unsharded argument bytes with the number of 80 GB H100s they
alone fill (``ceil(bytes / 80e9)``: a cell whose arguments fill one card
can run whole on one), the wall seconds, and for a meshed cell its
collective bytes a device by kind; then the ``toad_gbdt`` cell on a line.
The unsharded bytes come from ``launch.dryrun.lm_step`` on a 1×1 mesh (meta
tensors: shapes only, nothing traced).
"""

from __future__ import annotations

import argparse
import json
import math
import os

CARD_BYTES = 80e9


def unsharded_arg_bytes(arch: str, shape: str) -> int:
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lm_step
    from repro_torch.launch.mesh import make_test_mesh

    return lm_step(get_config(arch), make_test_mesh(1, 1), shape)["arg_bytes"]


def main(argv=None) -> None:
    from repro_torch.launch.sweep import SHAPE_NAMES, cells, out_path

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    recs = {}
    for arch, shape, mesh in cells():
        if mesh == args.mesh:
            path = out_path(args.results, arch, shape, mesh)
            if os.path.exists(path):
                with open(path) as f:
                    recs[arch, shape] = json.load(f)
    print("A cell: argument bytes a device / FLOPs a device / peak live bytes of the "
          "whole step (or a device's) / unsharded argument bytes and the 80 GB cards they "
          "fill / wall s [/ collective bytes a device by kind].")
    print()
    print("| arch (params total / active) | " + " | ".join(SHAPE_NAMES) + " |")
    print("|---" * (len(SHAPE_NAMES) + 1) + "|")
    for arch in dict.fromkeys(a for a, _, _ in cells() if a != "toad_gbdt"):
        r0 = next((r for (a, _), r in recs.items() if a == arch and r["status"] == "OK"), {})
        head = f"{arch} ({r0.get('params_total', 0):.4g} / {r0.get('params_active', 0):.4g})"
        out = []
        for shape in SHAPE_NAMES:
            r = recs.get((arch, shape))
            if r is None or r["status"] != "OK":
                out.append("missing" if r is None else f"{r['status']} ({r['wall_seconds']} s)")
                continue
            whole = unsharded_arg_bytes(arch, shape)
            probe = ", depth probe" if "probe" in r else ""
            if "peak_live_bytes_per_device" in r:
                peak = f"{r['peak_live_bytes_per_device']:.4g} a device"
                coll = r["collectives_per_device"]
                coll = " / " + ", ".join(f"{k} {v:.4g}" for k, v in coll.items() if v)
            else:
                peak, coll = f"{r['peak_live_bytes_global']:.4g}", ""
            out.append(f"{r['memory']['argument_size_in_bytes']:.4g} / "
                       f"{r['flops_per_device']:.4g} / {peak} / "
                       f"{whole:.4g}, {math.ceil(whole / CARD_BYTES)} / "
                       f"{r['wall_seconds']} s{probe}{coll}")
        print(f"| {head} | " + " | ".join(out) + " |")
    g = recs.get(("toad_gbdt", "default"))
    if g and g["status"] == "OK":
        coll = g["collectives_per_device"]
        print()
        print(f"toad_gbdt ({g['shape']}, {g['mesh']}): arguments "
              f"{g['memory']['argument_size_in_bytes']:,} B a rank, all-reduce {coll['total']:,} B a rank in "
              f"{g['collective_calls_per_device']} calls, bytes moved "
              f"{g['bytes_moved_per_device']:,}, peak {g['peak_live_bytes_per_device']:,} B a "
              f"rank, FLOPs (matrix products) {g['flops_per_device']:,}, {g['wall_seconds']} s.")


if __name__ == "__main__":
    main()
