#!/usr/bin/env python3
"""Why a bf16 decode step leaves a fresh prefill, on the card.

    PYTHONPATH=src python tools/lm_decode_rounding.py --arch rwkv6-1.6b

At full width and depth, on the serve CLI's weights (seed 0, then with the
constant entries redrawn as ``chip_smoke.py`` redraws them) and on two
token sets (the CLI's prompt and decoded tokens, and the CLI generator's
next S + check tokens), it decodes ``--check`` steps at position S+i and
holds each step's logits to a fresh prefill over S+i+1 tokens, under
settings that change only how the products and row reductions round and
leave every other operation as it is:

- ``served``: as the port serves (the process's defaults);
- ``f32_reduce``: cuBLAS may not reduce split-K partial sums in bf16
  (``allow_bf16_reduced_precision_reduction = False``);
- ``products_matched`` (RWKV-6): as ``rows_matched`` for the products
  alone;
- ``rows_matched`` (RWKV-6, whose block products and norms all see
  (B, 1, ...) rows at decode): each product and each reduction over the
  last dimension is padded with zero rows to the fresh prefill's
  B * (S+i+1) rows (``chip_smoke._rows_matched``; the prefill's final norm
  too), so the card picks the kernel and summation order the prefill's
  picks (the head's product has B rows in both already);
- ``f32_products``: every bf16 product computed in float32 (TF32 off) and
  rounded to bf16 once.

It prints one JSON line per (weights, tokens, setting): the argmax agreement and
max|Δ| over the ``B * check`` logit rows, the logits' spread, and for
RWKV-6 the last token's residual stream layer by layer (max|Δ| and the
relative norm of the difference), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SETTINGS = ("served", "f32_reduce", "products_matched", "rows_matched", "f32_products")
MATCHED = ("products_matched", "rows_matched")


@contextlib.contextmanager
def _setting(name: str):
    import torch

    from chip_smoke import f32_products

    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        if name == "f32_reduce":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        with f32_products() if name == "f32_products" else contextlib.nullcontext():
            yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def _residuals(mod):
    """Patch RWKV-6's ``_block`` to record the last token's residual stream
    after each layer; returns (the record, the undo)."""
    block = mod._block
    seen: list = []

    def recording(cfg, lp, x, *rest):
        out = block(cfg, lp, x, *rest)
        seen.append(out[0][:, -1].float())
        return out

    mod._block = recording
    return seen, lambda: setattr(mod, "_block", block)


def token_sets(arch: str, B: int, S: int, check: int) -> dict:
    """Two inputs of S + check tokens (and the side input the family
    takes, ones as the JAX CLI's): ``cli``, the serve CLI's prompt and
    decoded tokens (what ``chip_smoke.py`` replays), and ``generator``, S +
    check tokens from the CLI's generator."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config(arch)
    out = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len", str(S),
                      "--decode-steps", str(check)])
    dev = torch.device(out["device"])
    cli = torch.cat([torch.from_numpy(out["prompt"]),
                     torch.from_numpy(out["tokens"][:, :check])], 1).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(serve.LM_SEED + 1)
    n_text = serve.lm_layout(cfg, S)[2]
    assert n_text == S, "a VLM's patch slots are not replayed here"
    return {"cli": (cli, out["side"]),
            "generator": (torch.randint(0, cfg.vocab, (B, S + check), generator=gen,
                                        device=dev), out["side"])}


def run(arch: str, S: int, check: int, redraw: bool, settings, sets: dict) -> list:
    import torch

    from chip_smoke import _redraw_constants, _rows_matched
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import LM_SEED
    from repro_torch.models import get_model

    cfg = get_config(arch)
    model = get_model(cfg, torch.device("cuda"))
    params = model.init(LM_SEED)
    if redraw:
        _redraw_constants(params, 1)
    trace = cfg.family == "rwkv"
    rows = []
    for (source, (tokens, extra)), name in itertools.product(sets.items(), settings):
        if name in MATCHED and cfg.family != "rwkv":
            continue
        with torch.inference_mode(), _setting(name):
            _, cache = model.prefill(params, {"tokens": tokens[:, :S], **extra},
                                     max_seq=S + check)
            agree, max_abs, spread, gaps, layers, padded = [], 0.0, [], [], None, 0
            for i in range(check):
                seen, undo = _residuals(model.module) if trace and i == 0 else ([], None)
                if name in MATCHED:
                    mode, pre = (_rows_matched(S + i + 1, cfg.padded_vocab,
                                               name == "rows_matched") for _ in range(2))
                else:
                    mode = pre = contextlib.nullcontext()
                try:
                    with mode:
                        dec, cache = model.decode_step(params, cache, tokens[:, S + i])
                    with pre:
                        fresh, _ = model.prefill(params, {"tokens": tokens[:, : S + i + 1],
                                                          **extra})
                finally:
                    if undo:
                        undo()
                padded += getattr(mode, "padded", 0)
                if seen:
                    L = cfg.n_layers
                    d, f = seen[:L], seen[L:]
                    layers = [{"layer": j, "max_abs": float((d[j] - f[j]).abs().max()),
                               "rel": float((d[j] - f[j]).norm() / f[j].norm())}
                              for j in range(L)]
                dec = dec[:, : cfg.vocab].float()
                fresh = fresh[:, : cfg.vocab].float()
                agree.append(float((dec.argmax(-1) == fresh.argmax(-1)).float().mean()))
                max_abs = max(max_abs, float((dec - fresh).abs().max()))
                spread.append(float(fresh.std()))
                top2 = torch.topk(fresh, 2, dim=-1).values
                gaps.append((top2[:, 0] - top2[:, 1]).cpu())
            del cache
        row = {"arch": arch, "weights": "redrawn" if redraw else "seed 0", "tokens": source,
               "setting": name, "batch": tokens.shape[0], "prompt_len": S,
               "rows": tokens.shape[0] * check,
               "agreement": float(np.mean(agree)), "max_abs": max_abs,
               "logit_std": float(np.mean(spread)),
               "top2_gap_median": float(torch.cat(gaps).median())}
        if name in MATCHED:
            row["padded"] = padded
        if layers:
            row["layers"] = layers
        print(json.dumps(row), flush=True)
        rows.append(row)
    del params, model
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=None,
                    help="a full-width LM arch (repeatable; default rwkv6-1.6b)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--check", type=int, default=4, help="decode steps held to a prefill")
    ap.add_argument("--setting", action="append", choices=SETTINGS, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_decode_rounding: needs a CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "allow_bf16_reduced_precision_reduction":
                          torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}))
    for arch in args.arch or ["rwkv6-1.6b"]:
        sets = token_sets(arch, args.batch, args.prompt_len, args.check)
        for redraw in (False, True):
            run(arch, args.prompt_len, args.check, redraw, args.setting or SETTINGS, sets)
        del sets
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip() or 'not read'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
