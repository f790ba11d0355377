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
``latest_step`` sees only whole checkpoints.  JAX's ``restore`` reshapes
each record to its leaf's whole ``shape`` and ignores ``index``, so a
checkpoint both packages read holds whole leaves in one shard file.
JAX's ``shardings=`` argument (placing arrays on a mesh) becomes
``device=`` and, on a device mesh (a ``launch.mesh.RankMesh`` of
``torch.distributed`` ranks), ``mesh=`` with the tree's shardings
``specs=`` (``models.param_specs``, an optimizer's ``state_specs``):

* a meshed ``save`` (every rank of the mesh calls it with its shards)
  gathers each leaf whole over the axes that split it, cuts an uneven
  split's padding off, and rank 0 of the mesh writes the one shard file
  and the manifest and renames them, while the others wait at a barrier
  over the mesh's axes;
* a meshed ``restore`` reads the whole leaves on every rank and keeps
  this rank's block of each (``models.base.shard``: padded as XLA pads),
  whatever mesh wrote the checkpoint, the JAX package included.

Without a mesh both write and read what they did before meshes, to the
bit.  MessagePack is read and written by ``msgpack_lite`` (the card's
machine has no ``msgpack``); bf16 crosses as its raw 16-bit words, since
numpy there has no bfloat16.
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


def _whole(t: torch.Tensor, spec, shape, mesh) -> torch.Tensor:
    """The whole leaf of ``shape`` from this rank's shard ``t`` sharded as
    ``spec``: gathered over the axes that split each dimension (the minor
    axis first, so the blocks land in row-major order), the padding cut
    off."""
    from repro_torch.distributed.collectives import all_gather_dim
    from repro_torch.models.base import _axis_names, full_spec

    with torch.no_grad():
        for dim, e in enumerate(full_spec(spec, t.dim())):
            for a in reversed(_axis_names(e)):
                t = all_gather_dim(t, dim, mesh.group(a))
            t = t.narrow(dim, 0, shape[dim])
    return t


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for all: a barrier over each axis in
    turn (a rank leaves the last only once every rank entered the first)."""
    import torch.distributed as dist

    for a in mesh.axis_names:
        if mesh.axis_size(a) > 1:
            dist.barrier(group=mesh.group(a))


def save(ckpt_dir: str, step: int, tree, mesh=None, specs=None, shapes=None) -> str:
    """Write ``tree`` (tensors or arrays in dicts and lists) as checkpoint
    ``step-<step>``.  Returns its path.  On a ``mesh``, ``tree`` holds this
    rank's shards of leaves sharded as ``specs`` with the whole shapes
    ``shapes`` (parallel trees; module docstring): every rank of the mesh
    calls it, and rank 0 of the mesh writes."""
    from repro_torch.models.base import map_leaves

    if mesh is not None:
        tree = map_leaves(lambda _, t, spec, shape: _whole(t, spec, shape, mesh),
                          tree, specs, shapes)
        writer = all(i == 0 for i in mesh.coords.values())
        path = _write(ckpt_dir, step, tree) if writer else os.path.join(ckpt_dir,
                                                                        f"step-{step}")
        _barrier(mesh)
        return path
    return _write(ckpt_dir, step, tree)


def _write(ckpt_dir: str, step: int, tree) -> str:
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


def restore(ckpt_dir: str, step: int, template, device="cuda", mesh=None, specs=None):
    """``template``'s tree rebuilt from checkpoint ``step``, each leaf a
    tensor on ``device`` (the card unless the caller passes ``"cpu"``) with
    the stored dtype and shape; on a ``mesh``, this rank's shard of it by
    ``specs`` (a tree parallel to ``template``).  Raises ``KeyError`` on a
    leaf the checkpoint lacks."""
    from repro_torch.models.base import shard

    device = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step-{step}")
    data = {}
    for fn in sorted(os.listdir(d)):
        if fn.startswith("shard-"):
            with open(os.path.join(d, fn), "rb") as f:
                data.update(msgpack_lite.unpackb(f.read()))

    def rebuild(tree, spec, path=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, spec and spec[k], f"{path}[{k!r}]") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rebuild(v, spec and spec[i], f"{path}[{i}]") for i, v in enumerate(tree)]
        rec = data[path]
        if mesh is None:
            return _from_bytes(decompress(rec["data"]), rec["dtype"], rec["shape"], device)
        whole = _from_bytes(decompress(rec["data"]), rec["dtype"], rec["shape"], "cpu")
        return shard(whole, spec, mesh).to(device)

    return rebuild(template, specs)
