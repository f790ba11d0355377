"""Training launcher of the port (``repro.launch.train``): the GBDT and the
LM paths.

    # LM path (a reduced config on the CPU; full width on the card):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --reduced \
        --steps 6 --batch 2 --seq 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --steps 50 --batch 8 --seq 64 --ckpt-dir /path/to/ckpt

    # the paper's workload (ToaD GBDT) end to end, on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch toad_gbdt \
        --dataset covtype_binary
    # on a CPU-only machine, a small dataset:
    PYTHONPATH=src python -m repro_torch.launch.train --arch toad_gbdt \
        --dataset breast_cancer --steps 16 --device cpu

Loads a synthetic dataset (``data.synth``, drawn from a seed), splits and
bins it (``data.pipeline``), trains on ``--device`` and prints the test
metric, the ToaD stream size and the reuse factor.  ``--steps`` is the
number of boosting rounds.

The LM path (``--arch`` naming a language model) trains float32 masters
with the config's optimizer on ``lm_batch_fn``'s synthetic Zipf tokens
(the JAX package's draws), resuming from ``--ckpt-dir`` when it holds a
checkpoint; it prints the first and last loss, the ms a step (median
after the first) and the card's peak memory, and exits non-zero unless
the loss decreased.  An encoder-decoder (whisper) is refused: it trains
on audio frames, which ``lm_batch_fn`` does not make (the JAX package's
CLI fails there with ``KeyError: 'frames'``).
"""

from __future__ import annotations

import argparse

import numpy as np


def train_lm(args) -> dict:
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import get_model
    from repro_torch.train.loop import fit, lm_batch_fn

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit(f"--arch {args.arch}: an encoder-decoder trains on audio frames "
                         "(batch['frames']), and the LM batches carry tokens and labels "
                         "only; train it from Python with frames in the batch")
    device = resolve_device(args.device)
    model = get_model(cfg, device)
    batch_fn = lm_batch_fn(cfg, n_docs=1000, seq=args.seq, batch=args.batch, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step_ms: list = []
    params, losses = fit(model, batch_fn, steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, step_ms=step_ms)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    ms = float(np.median(step_ms[1:] or step_ms)) if step_ms else float("nan")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} device={device} ({where}) steps={len(losses)} "
          f"batch={args.batch} seq={args.seq} optimizer={cfg.optimizer}")
    if losses:
        print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
    print(f"{ms:.3f} ms/step (median after the first)"
          + (f", peak memory_allocated {peak:,} B" if peak is not None else ""))
    if len(losses) < 2 or not losses[-1] < losses[0]:
        raise SystemExit("loss must decrease: "
                         + (f"{losses[0]:.4f} -> {losses[-1]:.4f}" if losses else "no steps"))
    return {"device": str(device), "losses": losses, "step_ms": step_ms,
            "ms_per_step": ms, "peak_bytes": peak, "params": params}


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
    ap.add_argument("--arch", required=True, help="toad_gbdt or a language model")
    ap.add_argument("--reduced", action="store_true", help="the LM's reduced config")
    ap.add_argument("--steps", type=int, default=50,
                    help="boosting rounds (GBDT) or optimizer steps (LM)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--dataset", default="covtype_binary")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--penalty-feature", type=float, default=4.0)
    ap.add_argument("--penalty-threshold", type=float, default=1.0)
    ap.add_argument("--forestsize", type=float, default=0.0)
    args = ap.parse_args(argv)
    from repro_torch.configs import ARCHS, is_gbdt_arch

    if is_gbdt_arch(args.arch):
        return train_gbdt(args)
    if args.arch not in ARCHS:
        ap.error(f"--arch {args.arch!r}: not toad_gbdt nor one of {sorted(ARCHS)}")
    return train_lm(args)


if __name__ == "__main__":
    main()
