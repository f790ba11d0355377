"""Training launcher of the port (the GBDT path of ``repro.launch.train``).

    # the paper's workload (ToaD GBDT) end to end, on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch toad_gbdt \
        --dataset covtype_binary
    # on a CPU-only machine, a small dataset:
    PYTHONPATH=src python -m repro_torch.launch.train --arch toad_gbdt \
        --dataset breast_cancer --steps 16 --device cpu

Loads a synthetic dataset (``data.synth``, drawn from a seed), splits and
bins it (``data.pipeline``), trains on ``--device`` and prints the test
metric, the ToaD stream size and the reuse factor.  ``--steps`` is the
number of boosting rounds.  The LM path (``--arch`` naming a language
model) comes with slice 9 of the port.
"""

from __future__ import annotations

import argparse


def train_gbdt(args) -> dict:
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core import compression_summary, encode, reuse_factor
    from repro_torch.data.pipeline import split_dataset
    from repro_torch.data.synth import load
    from repro_torch.gbdt import GBDTConfig, apply_bins, make_loss, predict_binned, train

    device = resolve_device(args.device)
    ds = load(args.dataset, seed=1)
    sp = split_dataset(ds, seed=1, n_bins=64)
    cfg = GBDTConfig(
        task=ds.task, n_classes=ds.n_classes, n_rounds=args.steps or 64,
        max_depth=3, learning_rate=0.15,
        toad_penalty_feature=args.penalty_feature,
        toad_penalty_threshold=args.penalty_threshold,
        toad_forestsize=args.forestsize,
    )
    on = lambda a: torch.from_numpy(a).to(device)
    edges = on(sp.edges)
    bins = apply_bins(on(sp.x_train), edges)
    forest, hist, aux = train(cfg, bins, on(sp.y_train), edges)
    loss = make_loss(ds.task, ds.n_classes)
    test_pred = predict_binned(forest, apply_bins(on(sp.x_test), edges))
    metric = float(loss.metric(on(sp.y_test), test_pred))
    summary = compression_summary(forest)
    enc = encode(forest)
    ref = reuse_factor(forest)
    print(f"dataset={ds.name} device={device} metric={metric:.4f}")
    print(f"toad bytes={summary['toad_bytes']:.0f} "
          f"(x{summary['compression_vs_f32']:.1f} vs fp32 pointer)")
    print(f"ReF={ref:.2f}")
    print(f"encoded stream: {enc.n_bytes:.1f} bytes")
    return {"metric": metric, "toad_bytes": summary["toad_bytes"],
            "trainer_bytes": float(aux["toad_bytes"]), "reuse_factor": ref,
            "n_trees": int(forest.n_trees)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, help="toad_gbdt")
    ap.add_argument("--steps", type=int, default=50, help="boosting rounds")
    ap.add_argument("--dataset", default="covtype_binary")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--penalty-feature", type=float, default=4.0)
    ap.add_argument("--penalty-threshold", type=float, default=1.0)
    ap.add_argument("--forestsize", type=float, default=0.0)
    args = ap.parse_args(argv)
    from repro_torch.configs import is_gbdt_arch

    if not is_gbdt_arch(args.arch):
        ap.error(f"--arch {args.arch!r}: only the GBDT workload (toad_gbdt) is "
                 "ported so far; the LM training path comes with slice 9")
    return train_gbdt(args)


if __name__ == "__main__":
    main()
