#!/usr/bin/env python3
"""Whether rwkv6-1.6b on a (1, 4) mesh leaves one card by rounding, on the card.

    PYTHONPATH=src python tools/lm_mesh_rounding.py      # ~3 min on one H100

rwkv6-1.6b at full width and depth (``init``'s seeded weights), B 4, a
128-token prompt and 4 decode steps, on one card and on a (1, 4) mesh of 4
gloo ranks sharing it (``chip_smoke._one_card`` and ``_full_width_mesh``:
``[lm-mesh]``'s case), the mesh fed the one-card run's greedy tokens, under
each ``--setting``:

- ``served``: both sides as the port serves;
- ``f32_products``: ``tools/lm_decode_rounding.py``'s setting on both
  sides, every bf16 product in float32 (TF32 off) rounded to bf16 once
  (the mesh's row-parallel products already sum float32 partials);
- ``blocks_matched``: the mesh as served, and the one card's products
  split as the mesh splits them (``chip_smoke.blocks_matched``: each
  column-parallel product as its 4 column blocks' products, each
  row-parallel one as 4 float32 partials summed in float32), so that
  the card picks the ranks' kernels: only the order of the mesh's float32
  all-reduce is left between the two.

- ``blocks_reversed``: as ``blocks_matched``, the one card's float32
  partials summed in the reverse order;
- ``sum_order``: no mesh: the one card with its products split as
  ``blocks_matched`` splits them, against the same with each row-parallel
  product's 4 float32 partials summed in the reverse order: a
  perturbation of the kind the mesh's all-reduce order makes, with no
  mesh at all.

A head or block mapping fault shows in the first layers of
``blocks_matched``, where the ranks' products are the one card's; a
rounding difference starts at the ulp and grows with depth at the rate
``sum_order`` shows without a mesh.  (``f32_products`` does not remove
the rounding of a float32 product, which also depends on the kernel the
card picks for the product's shape.)

One JSON line a setting: max|Δ| and argmax agreement of the logits (the
prefill's and each decode step's), max|Δ| a step, and the prefill's
last-token residual stream after each layer on rank 0 against the one card
(max|Δ|, the relative norm of the difference); then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

ARCH = "rwkv6-1.6b"
SHAPE, B, S, STEPS = (1, 4), 4, 128, 4
RANKS = 4


SETTINGS = ("served", "f32_products", "blocks_matched", "blocks_reversed", "sum_order")


def _recorded(setting: str, run):
    """``run()`` under ``lm_decode_rounding``'s ``setting`` (``served``
    for ``blocks_matched``, which acts on the one card's run alone) with
    RWKV-6's residual stream recorded: (its result, the prefill's
    last-token residual after each layer, as numpy arrays, which cross a
    rank's result queue).  ``blocks_*`` and ``sum_order`` act on the one
    card's run alone, through ``chip_smoke._one_card``."""
    import repro_torch.models.rwkv6 as rwkv6
    from lm_decode_rounding import _residuals, _setting

    seen, undo = _residuals(rwkv6)
    try:
        with _setting("f32_products" if setting == "f32_products" else "served"):
            out = run()
    finally:
        undo()
    return out, [t.cpu().numpy() for t in seen]


def mesh_rank(rank, device, setting: str, inputs, layers: int) -> dict:
    """One rank: the meshed run of ``chip_smoke._full_width_mesh`` under
    ``setting``, with its prefill's residual stream."""
    from chip_smoke import _full_width_mesh

    out, seen = _recorded(setting, lambda: _full_width_mesh(ARCH, SHAPE, S + STEPS, inputs,
                                                            device, layers))
    out["residuals"] = seen
    return out


def compare(setting: str, one: dict, one_res: list, ranks: list, n_layers: int) -> dict:
    from repro_torch.configs import get_config

    vocab = get_config(ARCH).vocab
    want = np.concatenate([a[:, :vocab] for a in one["logits"]])
    got = np.concatenate([a[:, :vocab] for a in ranks[0]["logits"]])
    res = ranks[0]["residuals"]
    layers = [{"layer": j, "max_abs": float(np.abs(res[j] - one_res[j]).max()),
               "rel": float(np.linalg.norm(res[j] - one_res[j]) / np.linalg.norm(one_res[j]))}
              for j in range(n_layers)]
    return {"arch": ARCH, "mesh": None if setting == "sum_order" else list(SHAPE),
            "setting": setting, "layers_run": n_layers, "batch": B,
            "prompt_len": S, "steps": STEPS,
            "max_abs": float(np.abs(got - want).max()),
            "agreement": float(np.mean(got.argmax(-1) == want.argmax(-1))),
            "max_abs_a_step": [float(np.abs(a[:, :vocab] - b[:, :vocab]).max())
                               for a, b in zip(ranks[0]["logits"], one["logits"])],
            "ranks_equal": all(np.array_equal(r["logits"][i], ranks[0]["logits"][i])
                               for r in ranks for i in range(len(r["logits"]))),
            "layers": layers}


def main(argv=None) -> int:
    import torch

    from chip_smoke import _one_card
    from repro_torch.configs import get_config
    from repro_torch.gbdt.distributed import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--setting", action="append", choices=SETTINGS, default=None)
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: all 24)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_mesh_rounding: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    n_layers = args.layers or get_config(ARCH).n_layers
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    for setting in args.setting or SETTINGS:
        matched = SHAPE[1] if setting in ("blocks_matched", "blocks_reversed",
                                          "sum_order") else 0
        (one, batch, forced), one_res = _recorded(
            setting, lambda: _one_card(dev, ARCH, B, S, S + STEPS, STEPS, layers=args.layers,
                                       matched=matched, reverse=setting == "blocks_reversed"))
        if setting == "sum_order":  # the same products, the partials summed in reverse
            (other, _, _), other_res = _recorded(setting, lambda: _one_card(
                dev, ARCH, B, S, S + STEPS, STEPS, layers=args.layers, forced=forced,
                matched=SHAPE[1], reverse=True))
            ranks = [{**other, "residuals": other_res}]
        else:
            ranks = run_ranks(mesh_rank, RANKS, setting, (batch, forced), args.layers,
                              device=dev)
        print(json.dumps(compare(setting, one, one_res[:n_layers], ranks, n_layers)),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip() or 'not read'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
