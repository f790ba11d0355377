"""Meta-tensor stand-ins and shardings for every (arch × shape) cell of the
dry run (``repro.launch.input_specs``).

Shapes (the JAX package's):
  train_4k     seq 4096,   global batch 256  (training step)
  prefill_32k  seq 32768,  global batch 32   (inference prefill)
  decode_32k   seq 32768,  global batch 128  (one token, 32k KV cache)
  long_500k    seq 524288, global batch 1    (one token, 500k state) —
               SSM/hybrid only; full-attention archs are recorded as SKIP.

Modality stubs as there: whisper gets precomputed frame embeddings
(seq // frontend_len_div), llava patch embeddings (seq // frontend_len_div),
both bf16.

JAX's ``ShapeDtypeStruct`` stand-ins are tensors on the meta device here:
they carry a shape and a dtype and hold no memory.  A sharding is a tuple
with one entry a dimension (``launch/mesh.py``).  Token dtypes are the
ones the port's paths take: a training batch's tokens and labels are int32
(``train.loop.lm_batch_fn``, JAX's dtype); a serving prompt's tokens and a
decode step's token are **int64** (``launch/serve.py`` draws the prompt
with ``torch.randint`` and feeds back ``argmax``), where JAX's are int32.
Bytes are counted at the port's dtypes.
"""

from __future__ import annotations

import torch

from repro_torch.models.base import ModelConfig, with_dp, zeros_of

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

SUBQUADRATIC = {"rwkv", "hybrid"}  # families that run long_500k

META = torch.device("meta")


def skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    if shape == "long_500k" and cfg.family not in SUBQUADRATIC:
        return "full-attention arch: 500k decode excluded per assignment rule"
    return None


def _dp(mesh, batch: int):
    """Batch-sharding axes, dropping axes the batch can't cover (B=1)."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    size = 1
    dp = []
    for a in axes:
        if batch % (size * mesh.shape[a]) == 0:
            dp.append(a)
            size *= mesh.shape[a]
    return tuple(dp) if dp else None


def _info(shape) -> dict:
    """A shape's name in :data:`SHAPES`, or its dict (seq, batch, kind)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def batch_specs(cfg: ModelConfig, mesh, shape):
    """(batch of meta tensors, batch shardings, dp axes) for ``shape``, a
    name in :data:`SHAPES` or a dict of its form."""
    info = _info(shape)
    B, S = info["batch"], info["seq"]
    dp = _dp(mesh, B)
    tok = torch.int32 if info["kind"] == "train" else torch.int64
    D = cfg.d_model
    batch, spec = {}, {}
    if cfg.family in ("encdec", "vlm"):
        side = "frames" if cfg.family == "encdec" else "embeds"
        n_side = S // cfg.frontend_len_div
        batch[side] = torch.empty((B, n_side, D), dtype=torch.bfloat16, device=META)
        spec[side] = (dp, None, None)
    n_text = S - n_side if cfg.family == "vlm" else S
    batch["tokens"] = torch.empty((B, n_text), dtype=tok, device=META)
    spec["tokens"] = (dp, None)
    if info["kind"] == "train":
        batch["labels"] = torch.empty((B, S), dtype=tok, device=META)
        spec["labels"] = (dp, None)
    return batch, spec, dp


def decode_specs(cfg: ModelConfig, mesh, shape):
    """(cache of meta tensors, cache shardings, token, token sharding,
    position, dp axes) for one decode step of ``shape``.

    The cache's leaves are (shape, dtype, sharding) in the shardings tree;
    its ``length``, the position the step writes, is ``seq - 1``: a Python
    int in the port (JAX's is an int32 scalar on the devices), the last
    slot, so the step attends over the whole cache."""
    from repro_torch.models.registry import get_module

    info = _info(shape)
    B, S = info["batch"], info["seq"]
    dp = _dp(mesh, B)
    kw = {"enc_seq": S // cfg.frontend_len_div} if cfg.family == "encdec" else {}
    specs = with_dp(get_module(cfg).cache_specs(cfg, B, S, **kw), dp)
    pos = S - 1
    cache = {**zeros_of(specs, META), "length": pos}
    token = torch.empty((B,), dtype=torch.int64, device=META)
    return cache, specs, token, (dp,), pos, dp
