#!/usr/bin/env python3
"""Faults and the control of the multiclass fit cell (runner
``fit_sweep_multiclass``), and the readings its limits are set from.

    python3 bench/faults_multiclass.py --workload covtype_multi-fit --seeds a,b,...
        [--seconds S] [--control-seeds a,b] [--faults x,y --fault-seeds a,b]

Each reading is ``control.readings``: one run of the harness's own
``run_cell`` with the plant around it, of one fit (``min_fits`` 1 unless
``--overrides`` says otherwise) with ``--seconds`` 0.  The plants are those of
``faults.py`` for a fit (the control ``bf16_histograms``; the faults
``state_unchanged``, ``half_batch``, ``answer_altered``) and two of
multiclass's own:

  * ``sets_not_carried``: each class tree of a round starts from the used
    sets of the round's start, not from those the class before it left;
    the round still ends with every class's features and thresholds used;
  * ``second_nearest``: once the leaf table is full, each leaf with rows
    takes the stored value second nearest its own, and the scores advance
    by it.

Prints one JSON line a run, then the largest program reading and the
smallest reading of each other side, per number.
"""

import argparse
import contextlib
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import faults  # noqa: E402


@contextlib.contextmanager
def _wrap_grow_tree(change):
    """The trainer's ``_grow_tree`` replaced by ``change(orig, k, *args)``,
    ``k`` counting its calls (a fit calls it C times a round, every round)."""
    from repro_torch.gbdt import trainer

    orig = trainer._grow_tree
    calls = itertools.count()

    def grow(*args, **kw):
        return change(orig, next(calls), *args, **kw)

    with faults._patched(trainer, "_grow_tree", grow):
        yield


def fit_sets_not_carried():
    start = {}

    def change(orig, k, cfg, bins, g, h, edges, state, *rest, **kw):
        carried = state[:2]
        if k % cfg.n_ensembles == 0:
            start["sets"] = carried
        tree, contrib, n_sp, new = orig(cfg, bins, g, h, edges, (*start["sets"], *state[2:]),
                                        *rest, **kw)
        return tree, contrib, n_sp, (carried[0] | new[0], carried[1] | new[1], *new[2:])

    return _wrap_grow_tree(change)


def fit_second_nearest():
    import torch

    def change(orig, k, cfg, bins, g, h, edges, state, *rest, **kw):
        out = orig(cfg, bins, g, h, edges, state, *rest, **kw)
        table, n_leaf = state[2], state[3]
        if int(n_leaf) < table.shape[0]:
            return out
        (feat, thr, split, lref, gain, cnt), contrib, n_sp, new = out
        pos = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
        for _ in range(cfg.max_depth):  # the trainer's routing
            xb = bins.gather(1, feat.long()[pos][:, None])[:, 0].to(torch.int32)
            pos = 2 * pos + torch.where(~split[pos] | (xb <= thr[pos]), 1, 2)
        leaf = pos - (2**cfg.max_depth - 1)
        stats = torch.zeros((cnt.shape[0], 2), dtype=torch.float32, device=g.device)
        stats.index_add_(0, leaf, torch.stack([g, h], 1).to(torch.float32))
        value = -cfg.learning_rate * stats[:, 0] / (stats[:, 1] + cfg.reg_lambda)
        dist = (table[None, :] - value[:, None]).abs()
        dist.scatter_(1, lref.long()[:, None], torch.inf)  # not the nearest
        lref = torch.where(cnt > 0, dist.argmin(1).to(lref.dtype), lref)
        contrib = table[lref.long()[leaf]]
        return (feat, thr, split, lref, gain, cnt), contrib, n_sp, new

    return _wrap_grow_tree(change)


CONTROLS = {"fit_sweep_multiclass": faults.fit_bf16_histograms}

FAULTS = {"fit_sweep_multiclass": {
    "state_unchanged": faults.fit_state_unchanged, "half_batch": faults.fit_half_batch,
    "answer_altered": faults.fit_answer_altered, "sets_not_carried": fit_sets_not_carried,
    "second_nearest": fit_second_nearest}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="covtype_multi-fit")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="faults of FAULTS to plant")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}",
                    help="JSON merged into the cell's configuration and traffic")
    args = ap.parse_args(argv)
    import torch

    from bench.control import _seeds, readings
    from bench.core import spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("faults_multiclass: no CUDA card", file=sys.stderr)
        return 2
    overrides = spec._merge({"traffic": {"min_fits": 1}}, json.loads(args.overrides))
    cell = spec.cell(args.workload, overrides)
    runner = cell["traffic"]["runner"]
    runs = [("program", None, s) for s in _seeds(args.seeds)]
    runs += [("control", CONTROLS[runner], s) for s in _seeds(args.control_seeds)]
    runs += [(f"fault:{f}", FAULTS[runner][f], s)
             for f in args.faults.split(",") if f for s in _seeds(args.fault_seeds)]
    by_side: dict[str, list[dict]] = {}
    for side, plant, seed in runs:
        row = dict(side=side, seed=seed,
                   **readings(args.workload, seed, args.seconds, args.device, plant, overrides))
        print(json.dumps(row), flush=True)
        by_side.setdefault(side, []).append(row)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    summary = {k: dict(limit=limit, **{
        side: (max if side == "program" else min)(r[k] for r in rows)
        for side, rows in by_side.items()}) for k, limit in cell["traffic"]["checks"].items()}
    print(json.dumps(dict(summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
