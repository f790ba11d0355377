"""The dry-run sweep's records as a markdown table, and the meshed cells'
collectives reckoned from the code.

    PYTHONPATH=src python tools/dryrun_table.py --results DIR [--mesh single]
    PYTHONPATH=src python tools/dryrun_table.py --reckon [--mesh single]

Reads ``dryrun_*_{mesh}.json`` from a ``repro_torch.launch.sweep`` run and
prints one row an arch, one column a shape; a cell holds the argument
bytes a device on the production mesh, the FLOPs a device, the peak live
bytes a device (every LM cell traces the meshed step on rank 0), the
step's unsharded argument bytes with the number of 80 GB H100s they alone
fill (``ceil(bytes / 80e9)``: a cell whose arguments fill one card can run
whole on one), the wall seconds, and its collective bytes a device by
kind; then the ``toad_gbdt`` cell on a line.
The unsharded bytes come from ``launch.dryrun.lm_step`` on a 1×1 mesh (meta
tensors: shapes only, nothing traced).

``--reckon`` prints, for every meshed ``prefill_32k`` and ``train_4k`` cell
of the production mesh, rank 0's collective bytes by kind worked out from
the parameter tables alone (:func:`reckon`), nothing traced: the count a
trace must meet (``tests/test_torch_lm_mesh_dryrun.py`` holds the two equal
on reduced configs).
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


def _names(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def _walk(shapes, specs, path=""):
    """(path, whole shape, sharding) of every parameter leaf."""
    if isinstance(shapes, dict):
        for k in shapes:
            yield from _walk(shapes[k], specs[k], f"{path}.{k}")
    elif isinstance(shapes, list):
        for i, (a, b) in enumerate(zip(shapes, specs)):
            yield from _walk(a, b, f"{path}[{i}]")
    else:
        yield path, tuple(shapes), tuple(specs)


def _adafactor_sums(shape, spec, mesh) -> int:
    """Adafactor's float32 all-reduces for one leaf on ``mesh``: the row and
    column means over a dimension that axes of more than one rank split
    (one sum an axis), the mean of ``vr`` over the rows, and the RMS."""
    import math as m

    from repro_torch.launch.mesh import shard_shape

    local = shard_shape(shape, spec, mesh)
    split = [[a for a in _names(e) if mesh.shape[a] > 1] for e in spec]
    total = 4 * len({a for d in split for a in d})  # the RMS, a scalar an axis
    if len(shape) >= 2:
        total += 4 * len(split[-1]) * m.prod(local[:-1])  # vr
        total += 4 * len(split[-2]) * (m.prod(local[:-2]) * local[-1]  # vc
                                       + m.prod(local[:-2]))  # vr's mean over the rows
    return total


def _last_row_sum(cfg, path: str, name: str) -> bool:
    """Whether a row-parallel weight's float32 sum is the last operation
    of its rematerialised body, which the backward's recompute (it stops at
    the last tensor the backward saved) does not repeat: the MLP of the
    body's last layer, but rwkv6's, whose channel mix multiplies the sum by
    ``rr`` and so saves it."""
    import re

    if cfg.family == "rwkv":
        return False
    if cfg.family == "encdec":
        return name == "wod"
    if cfg.family == "hybrid":
        from repro_torch.models.rglru import segments

        seg, pos = (int(i) for i in re.findall(r"\[(\d+)\]", path))
        return name == "wod" and pos == len(segments(cfg)[seg][0]) - 1
    from repro_torch.models.transformer import group_flags

    last = f".groups[{len(group_flags(cfg)) - 1}]"
    return name in ("wod", "w_out") and path.startswith(last)


def _grad_sums(cfg, b: int, S: int, s_enc: int) -> int:
    """The backward's all-reduces over ``"model"`` of the gradients of the
    tensors whole on every ``"model"`` rank that feed its block (bytes, one
    a tensor a layer, in the activations' bf16 but rwkv6's ``ln_x`` and
    ``ln_x_b``, and an MoE's routing weights, float32), and of the head's
    input."""
    from repro_torch.models import transformer as T
    from repro_torch.models.rwkv6 import W_LORA

    D, dh, KVp = cfg.d_model, cfg.head_dim, cfg.padded_heads[0]
    act = lambda rows: 2 * rows * D  # noqa: E731  (a (rows, D) bf16 tensor)
    kv = lambda rows: 2 * 2 * rows * KVp * dh  # noqa: E731  (k and v)
    bs, q_norm = b * S, 4 * dh * cfg.qk_norm
    if cfg.family == "rwkv":  # four mixes and the channel mix's, tanh(zw A), ln_x and ln_x_b
        layers = cfg.n_layers * (5 * act(bs) + 2 * bs * W_LORA + 2 * 4 * D)
    elif cfg.family == "hybrid":
        from repro_torch.models.rglru import segments

        kinds = [k for pat, reps in segments(cfg) for _ in range(reps) for k in pat]
        layers = sum(2 * act(bs) + (kv(bs) + q_norm if k == "attn" else 0) for k in kinds)
    elif cfg.family == "encdec":  # q's input, k, v and the MLP's; cross k, v of the encoder
        n_enc = cfg.n_enc_layers or cfg.n_layers
        layers = (n_enc * (2 * act(b * s_enc) + kv(b * s_enc))
                  + cfg.n_layers * (3 * act(bs) + kv(bs) + kv(b * s_enc)))
    else:  # the attention input, k, v, q_norm and the MLP's (an MoE's routing weights)
        layers = sum(T._n_groups(cfg) * (2 * act(bs) + kv(bs) + q_norm
                                         + (4 * bs * cfg.top_k if flag else 0))
                     for flag in T.group_flags(cfg))
    return layers + act(bs)


def reckon(cfg, info: dict, mesh) -> dict:
    """Rank 0's collective bytes by kind in the meshed prefill or training
    step of ``cfg`` on ``mesh`` (a ``launch.mesh.Mesh``), from the code's
    rules, one a term:

    * all-gather: every weight split over ``"data"``, gathered whole over it
      at each use (once a step for the top, once a layer in a prefill,
      twice in a training step: the forward and the backward's recompute),
      at the weight's dtype (bf16 served, the ``F32_ENTRIES`` float32;
      float32 masters in training); in a prefill the last token's logits'
      vocabulary blocks over ``"model"`` (float32); rwkv6's gathered ``rr``
      (B/data, S, D) a layer (twice in training) and, serving, its two
      token-shift carries (B/data, D), bf16;
    * all-reduce: over ``"model"``, the embedding's rows (bf16, the text's
      tokens) and each row-parallel product's float32 sum (rows × D: a
      weight split over ``"model"`` on its contracted dimension, the MoE's
      combine of its experts' outputs; whisper's encoder on its frames),
      in training again for each body's recompute but its last
      (:func:`_last_row_sum`); in training the vocabulary-parallel cross
      entropy's row max, sum of exponentials and label logit (float32, one
      a row each) and the backward's sums of a gradient that feeds a
      ``"model"`` block (:func:`_grad_sums`); over the batch's axes, the
      global count of kept labels (int64) and the loss (float32), and
      every leaf's gradient shard over each batch axis that does not split
      the leaf (float32), and Adafactor's sums of its means and RMS over
      the axes that split a leaf;
    * reduce-scatter (training): each gathered weight's gradient, its shard.
    """
    import math as m

    from repro_torch.launch.input_specs import _dp
    from repro_torch.launch.mesh import Mesh, shard_shape
    from repro_torch.models.base import param_shapes, param_specs
    from repro_torch.models.registry import get_module

    train = info["kind"] == "train"
    B, S = info["batch"], info["seq"]
    dp = _dp(mesh, B)
    sizes = mesh.shape
    b = B // m.prod(sizes[a] for a in _names(dp))
    M, D, Vp = sizes.get("model", 1), cfg.d_model, cfg.padded_vocab
    no_data = Mesh(mesh.axis_names, tuple(1 if a == "data" else n for a, n in sizes.items()))
    f32 = get_module(cfg).F32_ENTRIES
    s_enc = S // cfg.frontend_len_div
    s_text = S - s_enc if cfg.family == "vlm" else S
    out = {"all-gather": 0, "all-reduce": 0}
    if train:
        out["reduce-scatter"] = 0
    batch_axes = [a for a in _names(dp) if sizes[a] > 1]
    for path, shape, spec in _walk(param_shapes(cfg), param_specs(cfg)):
        name = path.rsplit(".", 1)[-1]
        stacked = not path.startswith(".top")
        n, per = (shape[0], shape[1:]) if stacked else (1, shape)
        pspec = spec[1:] if stacked else spec
        size = 4 if train or name in f32 else 2
        axes = {a for e in pspec for a in _names(e)}
        if "data" in axes and sizes["data"] > 1:
            uses = 2 if train and stacked else 1
            out["all-gather"] += uses * n * size * m.prod(shard_shape(per, pspec, no_data))
            if train:
                out["reduce-scatter"] += n * 4 * m.prod(shard_shape(per, pspec, mesh))
        if train:  # the leaf's gradient summed over the batch axes that do not split it
            lacking = [a for a in batch_axes if a not in axes]
            out["all-reduce"] += len(lacking) * 4 * m.prod(shard_shape(shape, spec, mesh))
            if cfg.optimizer == "adafactor":
                out["all-reduce"] += _adafactor_sums(shape, spec, mesh)
        if M == 1 or not stacked or len(pspec) < 2:  # the embedding is looked up, not a product
            continue
        rows = b * (s_enc if path.startswith(".enc") else S)
        if per[-1] == D and ("model" in _names(pspec[-2]) if len(per) == 2
                             else name == "w_out"):  # the MoE's experts' outputs
            again = train and not _last_row_sum(cfg, path, name)
            out["all-reduce"] += n * 4 * rows * D * (1 + again)
    if M > 1:
        out["all-reduce"] += 2 * b * s_text * D
        if cfg.family == "rwkv":
            out["all-gather"] += cfg.n_layers * 2 * (2 * b * S * D if train
                                                     else b * S * D + 2 * b * D)
        if train:
            out["all-reduce"] += 3 * 4 * b * S + _grad_sums(cfg, b, S, s_enc)
        else:
            out["all-gather"] += 4 * b * Vp
    if train:
        out["all-reduce"] += len(batch_axes) * (8 + 4)
    return out


def main(argv=None) -> None:
    from repro_torch.launch.sweep import SHAPE_NAMES, cells, out_path

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", default=None)
    ap.add_argument("--reckon", action="store_true")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    if args.reckon:
        from repro_torch.configs import get_config
        from repro_torch.launch.input_specs import SHAPES
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh(multi_pod=args.mesh == "multi")
        for arch, shape, mesh_name in cells():
            cfg = None if arch == "toad_gbdt" else get_config(arch)
            if mesh_name != args.mesh or shape not in ("prefill_32k", "train_4k") or cfg is None:
                continue
            got = reckon(cfg, SHAPES[shape], mesh)
            print(f"{arch} {shape} {args.mesh}: " + ", ".join(
                f"{k} {v:,}" for k, v in got.items()) + f", total {sum(got.values()):,}")
        return
    if args.results is None:
        ap.error("--results DIR, or --reckon")
    recs = {}
    for arch, shape, mesh in cells():
        if mesh == args.mesh:
            path = out_path(args.results, arch, shape, mesh)
            if os.path.exists(path):
                with open(path) as f:
                    recs[arch, shape] = json.load(f)
    print("A cell: argument bytes a device / FLOPs a device / peak live bytes a device "
          "/ unsharded argument bytes and the 80 GB cards they "
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
            peak = f"{r['peak_live_bytes_per_device']:.4g} a device"
            coll = r["collectives_per_device"]
            coll = " / " + ", ".join(f"{k} {v:.4g}" for k, v in coll.items() if v)
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
