"""Atomic checkpoints in the JAX package's on-disk format (the port's
``repro.distributed.checkpoint``): a checkpoint written by either package
restores in the other.

Layout of ``<dir>/step-<step>/``:

* ``shard-0.mpz``: one MessagePack map from each leaf's key to ``{index,
  data, dtype, shape}``, the key spelled as ``jax.tree_util.keystr``
  spells its path (``['params']['top']['embed']``,
  ``['opt']['m']['groups'][0]['wq']``), ``data`` the C-order bytes
  compressed with zstd where ``zstandard`` imports, else zlib (reading
  sniffs the frame magic), ``dtype`` numpy's name (``bfloat16`` for bf16),
  ``index`` the whole array's ``[[0, n], ...]``;
* ``manifest.json``: ``{"step", "leaves": {key: {"shape", "dtype"}}}``.

Every write goes to ``tmp-<step>-0`` and is renamed to ``step-<step>``
in one step, so a crash mid-save leaves no ``step-*`` behind and
``latest_step`` sees only whole checkpoints.  On one card there is one
process and one shard; JAX's ``shardings=`` argument (placing arrays on a
mesh) becomes ``device=``.  MessagePack is read and written by
``msgpack_lite`` (the card's machine has no ``msgpack``); bf16 crosses as
its raw 16-bit words, since numpy there has no bfloat16.
"""

from __future__ import annotations

import json
import os
import re
import zlib

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.distributed import msgpack_lite

try:
    import zstandard
except ImportError:  # no zstd: fall back to stdlib zlib
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"  # zstd frame header
_PROCESS = 0  # one process on one card


def compress(data: bytes) -> bytes:
    """zstd level 3 when ``zstandard`` imports, else zlib level 3."""
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(data)
    return zlib.compress(data, 3)


def decompress(data: bytes) -> bytes:
    """Either codec, told apart by the zstd frame magic."""
    if bytes(data[:4]) == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError("checkpoint shard is zstd-compressed; install 'zstandard' "
                               "to load it")
        return zstandard.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)


def _flatten(tree, path: str = ""):
    """(keystr, leaf) in ``jax.tree_util``'s order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    else:
        yield path, tree


def _to_bytes(t) -> tuple[bytes, str, list]:
    """A tensor's (or array's) C-order bytes, numpy dtype name and shape."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16", list(t.shape)
        t = t.numpy()
    a = np.asarray(t)
    return np.ascontiguousarray(a).tobytes(), str(a.dtype), list(a.shape)


def _from_bytes(raw: bytes, dtype: str, shape: list, device) -> torch.Tensor:
    if dtype == "bfloat16":
        a = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16).to(device)
    a = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(a.copy()).to(device)


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` (tensors or arrays in dicts and lists) as checkpoint
    ``step-<step>``.  Returns its path."""
    tmp = os.path.join(ckpt_dir, f"tmp-{step}-{_PROCESS}")
    final = os.path.join(ckpt_dir, f"step-{step}")
    os.makedirs(tmp, exist_ok=True)
    shards = {}
    manifest = {"step": step, "leaves": {}}
    for key, leaf in _flatten(tree):
        raw, dtype, shape = _to_bytes(leaf)
        manifest["leaves"][key] = {"shape": shape, "dtype": dtype}
        shards[key] = {"index": [[0, s] for s in shape], "data": compress(raw),
                       "dtype": dtype, "shape": shape}
    with open(os.path.join(tmp, f"shard-{_PROCESS}.mpz"), "wb") as f:
        f.write(msgpack_lite.packb(shards))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The largest ``step-<n>`` in ``ckpt_dir`` (``tmp-*`` ignored), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1))
             for m in (re.match(r"step-(\d+)$", d) for d in os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template, device="cuda"):
    """``template``'s tree rebuilt from checkpoint ``step``, each leaf a
    tensor on ``device`` (the card unless the caller passes ``"cpu"``) with
    the stored dtype and shape.  Raises ``KeyError`` on a leaf the
    checkpoint lacks."""
    device = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step-{step}")
    data = {}
    for fn in sorted(os.listdir(d)):
        if fn.startswith("shard-"):
            with open(os.path.join(d, fn), "rb") as f:
                data.update(msgpack_lite.unpackb(f.read()))

    def rebuild(tree, path=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{path}[{k!r}]") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rebuild(v, f"{path}[{i}]") for i, v in enumerate(tree)]
        rec = data[path]
        return _from_bytes(decompress(rec["data"]), rec["dtype"], rec["shape"], device)

    return rebuild(template)
