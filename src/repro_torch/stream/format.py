"""The ``.toadpack`` v4 streaming container (block-aligned ToaD layout).

Sections are ordered by access pattern, so a reader touches bytes in the
same order a cold-start needs them:

.. code-block:: text

    offset 0    b"TOADPACK"                magic (8 bytes)
    offset 8    uint32 LE = 4              container format version
    offset 12   uint64 LE = manifest_len   manifest byte length
    offset 20   manifest JSON              offsets, digests, tree_order
    ...         header blob                ToaD sections 1-4: metadata,
                                           feature map, threshold/leaf
                                           codebooks (bit-packed, the
                                           classic stream's prefix)
    ...         tree block 0..B-1          TREE_BLOCK trees each, byte-
                                           aligned, sha256 per block
    ...         fingerprint                (n_probe, C) f32 probe preds

The payload *is* the classic ToaD bit stream of the permuted forest — the
header blob is its sections 1-4 prefix and each block is a contiguous bit
range of the trees section, re-aligned to a byte boundary.  Reassembling
header + blocks bit-for-bit reproduces a stream ``core.layout.decode``
accepts, which is how the verifier reuses the TOAD00x stream walk.

Trees are permuted **most-informative-first**: descending per-tree mass
``sum |leaf_values[leaf_ref]|`` over *reachable* leaf slots, so the first
blocks a client decodes carry the largest score contributions (the ordering
ROADMAP item 4's early exit builds on).  The permutation is recorded in the
manifest (``tree_order[pos] = original tree index``); multiclass trees keep
their class identity through it (class of stream position ``p`` is
``tree_order[p] % C``), so *any* permutation converges to the classic
predictions.

The port's copy of ``repro.stream.format``: encoding goes through the
port's ``core.layout`` and ``core.treeorder``, and for the same forest and
``tree_order`` :func:`write_pack` writes the JAX package's bytes (manifest,
blocks, digests), so a pack written by either package opens in the other.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from repro_torch._device import host

from repro_torch.core.layout import encode, stream_offsets
from repro_torch.core.treeorder import remaining_mass, tree_order_most_informative

__all__ = [
    "PACK_MAGIC",
    "PACK_FORMAT_VERSION",
    "TREE_BLOCK",
    "write_pack",
    "read_manifest",
    "is_pack",
    "tree_order_most_informative",  # re-export: lives in core.treeorder
]

PACK_MAGIC = b"TOADPACK"
PACK_FORMAT_VERSION = 4
TREE_BLOCK = 8

#: fixed-offset prelude: magic, uint32 version, uint64 manifest length
_PRELUDE_BYTES = 8 + 4 + 8


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _permute_trees(forest, order: np.ndarray):
    """The same forest with its first ``K`` tree rows reordered by ``order``
    (tensors on the forest's device)."""
    import dataclasses

    K = int(forest.n_trees)
    idx = torch.as_tensor(np.asarray(order, np.int64), device=forest.device)
    updates = {}
    for name in ("feature", "thr_bin", "is_split", "leaf_ref"):
        arr = getattr(forest, name).clone()
        arr[:K] = arr[:K][idx]
        updates[name] = arr
    return dataclasses.replace(forest, **updates)


def _tree_bit_lengths(forest, header: dict) -> np.ndarray:
    """Exact per-tree bit length inside the trees section (closed form)."""
    K = int(forest.n_trees)
    I = 2 ** header["D"] - 1
    L = 2 ** header["D"]
    splits = host(forest.is_split)[:K].sum(axis=1).astype(np.int64)
    return (
        I * header["fu_bits"]
        + splits * header["tidx_bits"]
        + L * header["leaf_bits"]
    )


def _bit_slice(bits: np.ndarray, start: int, end: int) -> bytes:
    """Bits ``[start, end)`` of an unpacked stream, re-aligned to bytes."""
    return np.packbits(bits[start:end]).tobytes()


def write_pack(
    model,
    path: str,
    *,
    tree_block: int = TREE_BLOCK,
    tree_order: np.ndarray | None = None,
    early_exit=None,
) -> str:
    """Write a fitted (compressed) model as a ``.toadpack`` v4 container.

    ``tree_order`` overrides the default most-informative-first permutation
    (any permutation of ``range(n_trees)`` is valid — the manifest records
    it and the progressive scorer maps classes through it).  The manifest
    always embeds the early-exit ``remaining_mass`` bound table for this
    order (so ``ProgressiveScorer.feed_until_confident`` works on any
    pack); ``early_exit`` optionally ships an
    :class:`~repro_torch.gbdt.early_exit.EarlyExitPolicy` alongside it
    (default: the model's ``early_exit_policy``, if set).  Returns the
    path written.  ``repro_torch.api.artifact.save_streaming`` is the
    public entry point and adds post-write verification.
    """
    from repro_torch.api.artifact import (
        _FINGERPRINT_N,
        _FINGERPRINT_PRED_ATOL,
        _FINGERPRINT_SEED,
        probe_predictions,
        stream_digest,
    )

    if tree_block < 1:
        raise ValueError("tree_block must be >= 1")
    forest = model.forest
    K = int(forest.n_trees)
    cb_bits = model.encoded.thr_codebook_bits if model.encoded is not None else 0

    if tree_order is None:
        order = tree_order_most_informative(forest)
    else:
        order = np.asarray(tree_order, np.int64)
        if sorted(order.tolist()) != list(range(K)):
            raise ValueError(
                f"tree_order must be a permutation of range({K})"
            )

    # the payload is the classic ToaD stream of the *permuted* forest; its
    # header prefix (sections 1-4) is permutation-invariant
    enc = encode(_permute_trees(forest, order) if K else forest,
                 thr_codebook_bits=cb_bits)
    so = stream_offsets(enc)
    trees_start = so.sections["trees"][0]
    bits = np.unpackbits(np.asarray(enc.data, np.uint8))[: enc.n_bits]

    lengths = _tree_bit_lengths(forest, so.header)[order] if K else np.zeros(0, np.int64)
    bounds = trees_start + np.concatenate([[0], np.cumsum(lengths)])
    assert int(bounds[-1]) == enc.n_bits, "tree bit accounting is off"

    header_bytes = _bit_slice(bits, 0, trees_start)
    blocks: list[dict] = []
    payloads: list[bytes] = [header_bytes]
    offset = _PRELUDE_BYTES  # manifest length is added once it is known
    header_entry = {
        "n_bytes": len(header_bytes),
        "n_bits": int(trees_start),
        "sha256": _sha256(header_bytes),
    }
    for b0 in range(0, K, tree_block):
        b1 = min(b0 + tree_block, K)
        blob = _bit_slice(bits, int(bounds[b0]), int(bounds[b1]))
        payloads.append(blob)
        blocks.append({
            "n_bytes": len(blob),
            "n_bits": int(bounds[b1] - bounds[b0]),
            "n_trees": b1 - b0,
            "tree_pos": b0,  # first stream position this block covers
            "sha256": _sha256(blob),
        })

    fp_preds = probe_predictions(forest)  # original order: order-independent
    fp_bytes = np.ascontiguousarray(fp_preds, np.float32).tobytes()
    fingerprint = {
        "n_probe": _FINGERPRINT_N,
        "seed": _FINGERPRINT_SEED,
        "pred_atol": _FINGERPRINT_PRED_ATOL,
        "shape": list(fp_preds.shape),
        "n_bytes": len(fp_bytes),
        "sha256": _sha256(fp_bytes),
    }
    payloads.append(fp_bytes)

    import dataclasses

    policy = early_exit
    if policy is None:
        policy = getattr(model, "early_exit_policy", None)
    early_exit_entry = {
        "remaining_mass": [[float(v) for v in row]
                           for row in remaining_mass(forest, order)],
        "policy": policy.to_dict() if policy is not None else None,
    }

    manifest = {
        "format": "toadpack",
        "format_version": PACK_FORMAT_VERSION,
        "tree_block": int(tree_block),
        "n_trees": K,
        "n_blocks": len(blocks),
        "tree_order": [int(t) for t in order.tolist()],
        "n_ensembles": int(forest.n_ensembles),
        "n_features": int(forest.n_features),
        "max_depth": int(forest.max_depth),
        "thr_codebook_bits": int(cb_bits),
        "n_bits": int(enc.n_bits),
        "stream_sha256": stream_digest(enc),
        "config": dataclasses.asdict(model.config),
        "n_bins": model.n_bins,
        "spec": model.spec.to_dict() if model.spec is not None else None,
        "early_exit": early_exit_entry,
        "header": header_entry,
        "blocks": blocks,
        "fingerprint": fingerprint,
    }
    # offset fix-up to a fixed point: the manifest's own length shifts every
    # section, and the offsets' digits count in that length.  The JAX
    # package stops after two passes, so when an offset gains a digit on the
    # second pass it writes every offset short (and its own verify_pack
    # refuses the pack); wherever two passes settle, the bytes are the same
    doc_len = None
    while True:
        doc = json.dumps(manifest).encode("utf-8")
        if len(doc) == doc_len:
            break
        doc_len = len(doc)
        offset = _PRELUDE_BYTES + doc_len
        manifest["header"]["offset"] = offset
        offset += manifest["header"]["n_bytes"]
        for blk in manifest["blocks"]:
            blk["offset"] = offset
            offset += blk["n_bytes"]
        manifest["fingerprint"]["offset"] = offset

    with open(path, "wb") as f:
        f.write(PACK_MAGIC)
        f.write(int(PACK_FORMAT_VERSION).to_bytes(4, "little"))
        f.write(len(doc).to_bytes(8, "little"))
        f.write(doc)
        for blob in payloads:
            f.write(blob)
    return path


def read_manifest(path: str) -> dict:
    """Parse the fixed-offset prelude + manifest JSON of a ``.toadpack``.

    Raises ``ValueError`` on a non-pack file or unsupported version; the
    structural checks beyond that live in ``repro_torch.analysis.verify
    .verify_pack``.
    """
    with open(path, "rb") as f:
        prelude = f.read(_PRELUDE_BYTES)
        if len(prelude) < _PRELUDE_BYTES or prelude[:8] != PACK_MAGIC:
            raise ValueError(f"{path}: not a .toadpack container")
        version = int.from_bytes(prelude[8:12], "little")
        if version > PACK_FORMAT_VERSION:
            raise ValueError(
                f"{path}: .toadpack format version {version} is newer than "
                f"this runtime supports (max {PACK_FORMAT_VERSION})"
            )
        n = int.from_bytes(prelude[12:20], "little")
        doc = f.read(n)
    if len(doc) < n:
        raise ValueError(f"{path}: manifest truncated "
                         f"({len(doc)} of {n} bytes)")
    return json.loads(doc.decode("utf-8"))


def is_pack(path: str) -> bool:
    """True iff ``path`` starts with the ``.toadpack`` magic."""
    try:
        with open(path, "rb") as f:
            return f.read(8) == PACK_MAGIC
    except OSError:
        return False
