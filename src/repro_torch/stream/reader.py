"""Lazy ``.toadpack`` access: header parse, per-block decode, fallback open.

:class:`BlockReader` memory-maps the container and yields decoded tree
blocks on demand — a block's bytes are touched (and its sha256 verified)
only when that block is requested, so a cold start pays for the manifest,
the header tables and exactly the blocks it has consumed so far.  Per-tree
decode reuses the classic layout machinery: the header blob *is* the
sections 1-4 prefix of a ToaD stream (parsed with
``core.layout.stream_offsets`` semantics via :class:`~repro_torch.core
.bitio.BitReader`), and each block is a contiguous bit range of the trees
section.

:func:`open_streaming` is the one entry point: a ``.toadpack`` validates
its manifest + codebooks up front (blocks stay unread); anything else falls
back to the classic ``load_checked`` path, so v1-v3 ``.toad`` bundles serve
identically through either API.

The port's copy of ``repro.stream.reader``.  Decoding stays on the host
(numpy, as the bit reader is); :func:`open_streaming` takes the port's
``device`` (default ``"cuda"``), on which a classic bundle's model is
loaded and a pack's scorer evaluates its blocks.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.api.artifact import ArtifactError, load_checked
from repro_torch.core.bitio import BitReader, bits_for
from repro_torch.core.layout import (
    META_C_BITS,
    META_D_BITS,
    META_DEPTH_BITS,
    META_FU_BITS,
    META_K_BITS,
    META_MAXT_BITS,
    META_NCB_BITS,
    META_NLEAF_BITS,
)
from repro_torch.stream import format as pack_format


class StreamingError(ArtifactError):
    """A ``.toadpack`` container is structurally unsafe to serve from.

    Subclasses :class:`~repro_torch.api.artifact.ArtifactError` so fleet
    admission treats a refused pack exactly like a refused bundle.  The
    message carries the TOAD11x diagnostic code.
    """


@dataclasses.dataclass
class PackHeader:
    """Parsed sections 1-4 of the stream: everything but the trees.

    These are the tables every tree block resolves against — available
    after reading only ``header.n_bytes`` of payload, which is what makes
    progressive serving possible.
    """

    n_ensembles: int
    n_trees: int
    max_depth: int
    n_features: int
    base_score: np.ndarray       # (C,) float32
    used_features: np.ndarray    # (|F_U|,) int32
    counts: np.ndarray           # (|F_U|,) int32 thresholds per feature
    thr_table: np.ndarray        # (sum counts,) float32
    thr_offsets: np.ndarray      # (|F_U|+1,) int32
    leaf_values: np.ndarray      # (V,) float32
    cb_table: np.ndarray | None  # (n_cb,) float32 for codebook streams
    n_fu: int
    fu_bits: int
    tidx_bits: int
    leaf_bits: int


def _parse_header(blob: np.ndarray, n_bits: int, cb_bits: int) -> PackHeader:
    """Decode the metadata/feature-map/codebook/leaf sections of the prefix."""
    r = BitReader(np.asarray(blob, np.uint8), n_bits)
    C = r.read(META_C_BITS)
    K = r.read(META_K_BITS)
    D = r.read(META_DEPTH_BITS)
    d = r.read(META_D_BITS)
    n_fu = r.read(META_FU_BITS)
    max_t = r.read(META_MAXT_BITS)
    n_leaf = r.read(META_NLEAF_BITS)
    base = r.read_f32_array(C).astype(np.float32)

    cnt_bits = bits_for(max_t)
    fidx_bits = bits_for(d)
    feat_input = np.zeros(n_fu, np.int32)
    feat_count = np.zeros(n_fu, np.int32)
    cb_table = None
    if cb_bits > 0:
        n_cb = r.read(META_NCB_BITS)
        cb_ref_bits = bits_for(n_cb)
        for i in range(n_fu):
            feat_input[i] = r.read(fidx_bits)
            feat_count[i] = r.read(cnt_bits) + 1
        cb_table = r.read_f32_array(n_cb)
        thr_offsets = np.zeros(n_fu + 1, np.int32)
        np.cumsum(feat_count, out=thr_offsets[1:])
        refs = r.read_array(cb_ref_bits, int(thr_offsets[-1]))
        thr_table = cb_table[refs.astype(np.int64)] if n_cb else np.zeros(
            int(thr_offsets[-1]), np.float32)
    else:
        feat_width = np.zeros(n_fu, np.int32)
        feat_isfloat = np.zeros(n_fu, bool)
        for i in range(n_fu):
            feat_input[i] = r.read(fidx_bits)
            feat_width[i] = 2 ** r.read(3)
            feat_isfloat[i] = bool(r.read(1))
            feat_count[i] = r.read(cnt_bits) + 1
        thr_offsets = np.zeros(n_fu + 1, np.int32)
        np.cumsum(feat_count, out=thr_offsets[1:])
        thr_table = np.zeros(int(thr_offsets[-1]), np.float32)
        for i in range(n_fu):
            c = int(feat_count[i])
            if feat_isfloat[i] and feat_width[i] == 32:
                vals = r.read_f32_array(c)
            elif feat_isfloat[i] and feat_width[i] == 16:
                vals = (r.read_array(16, c).astype(np.uint16)
                        .view(np.float16).astype(np.float32))
            else:
                vals = r.read_array(int(feat_width[i]), c).astype(np.float32)
            thr_table[thr_offsets[i]:thr_offsets[i + 1]] = vals

    leaf_values = r.read_f32_array(max(n_leaf, 1))
    if r.remaining != 0:
        raise StreamingError(
            f"TOAD112: header blob has {r.remaining} bits beyond the "
            f"leaf table — the manifest header length is wrong"
        )
    return PackHeader(
        n_ensembles=C, n_trees=K, max_depth=D, n_features=d,
        base_score=base, used_features=feat_input, counts=feat_count,
        thr_table=thr_table.astype(np.float32), thr_offsets=thr_offsets,
        leaf_values=leaf_values.astype(np.float32), cb_table=cb_table,
        n_fu=n_fu, fu_bits=bits_for(n_fu + 1), tidx_bits=bits_for(max_t),
        leaf_bits=bits_for(max(n_leaf, 1)),
    )


@dataclasses.dataclass
class TreeBlock:
    """One decoded block: ``n_trees`` consecutive stream positions.

    ``orig_ids[j]`` is the original (training-order) index of the block's
    j-th tree; ``class_ids[j] = orig_ids[j] % C`` keeps multiclass trees
    accumulating into the class they were trained for, whatever the
    ``tree_order`` permutation did to their stream position.
    """

    index: int
    tree_pos: int               # first stream position covered
    orig_ids: np.ndarray        # (Tb,) int64
    class_ids: np.ndarray       # (Tb,) int32
    feature: np.ndarray         # (Tb, I) int32 input feature (-1 = no split)
    thr_value: np.ndarray       # (Tb, I) float32
    is_split: np.ndarray        # (Tb, I) bool
    leaf_ref: np.ndarray        # (Tb, L) int32

    @property
    def n_trees(self) -> int:
        return len(self.orig_ids)

    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in (
            self.orig_ids, self.class_ids, self.feature,
            self.thr_value, self.is_split, self.leaf_ref)))


class BlockReader:
    """mmap-backed lazy access to a ``.toadpack``'s tree blocks.

    Bytes for block ``i`` are only read (and the block's sha256 only
    verified, once) when :meth:`block_bytes`/:meth:`decode_block` is
    called.  ``verify=False`` skips the digests (trusted local packs).
    """

    def __init__(self, path: str, manifest: dict | None = None,
                 verify: bool = True):
        self.path = str(path)
        self.manifest = manifest if manifest is not None else \
            pack_format.read_manifest(self.path)
        self.verify = verify
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        self._checked: set[int] = set()

    @property
    def n_blocks(self) -> int:
        return int(self.manifest["n_blocks"])

    def __len__(self) -> int:
        return self.n_blocks

    def _slice(self, entry: dict, what: str) -> np.ndarray:
        off, n = int(entry["offset"]), int(entry["n_bytes"])
        if off < 0 or off + n > len(self._mm):
            raise StreamingError(
                f"TOAD112: {self.path}: {what} [{off}, {off + n}) runs past "
                f"the {len(self._mm)}-byte container (truncated pack)"
            )
        return np.array(self._mm[off:off + n])  # copy: detach from the map

    def _verified(self, entry: dict, what: str, cache_key: int | None = None
                  ) -> np.ndarray:
        blob = self._slice(entry, what)
        if self.verify and (cache_key is None or cache_key not in self._checked):
            got = hashlib.sha256(blob.tobytes()).hexdigest()
            if got != entry["sha256"]:
                raise StreamingError(
                    f"TOAD111: {self.path}: {what} sha256 mismatch — the "
                    f"block bytes do not match the manifest digest "
                    f"(corrupted or reordered payload)"
                )
            if cache_key is not None:
                self._checked.add(cache_key)
        return blob

    def header_blob(self) -> tuple[np.ndarray, int]:
        """(bytes, n_bits) of the verified sections 1-4 prefix."""
        entry = self.manifest["header"]
        return self._verified(entry, "header", cache_key=-1), int(entry["n_bits"])

    def block_bytes(self, i: int) -> tuple[np.ndarray, dict]:
        """(verified bytes, manifest entry) of tree block ``i``."""
        entry = self.manifest["blocks"][i]
        return self._verified(entry, f"tree block {i}", cache_key=i), entry

    def decode_block(self, i: int, header: PackHeader) -> TreeBlock:
        """Decode block ``i`` against the header tables (bit-exact)."""
        blob, entry = self.block_bytes(i)
        r = BitReader(blob, int(entry["n_bits"]))
        Tb = int(entry["n_trees"])
        D = header.max_depth
        I, L = 2 ** D - 1, 2 ** D
        n_fu = header.n_fu
        feature = np.full((Tb, I), -1, np.int32)
        thr_value = np.zeros((Tb, I), np.float32)
        is_split = np.zeros((Tb, I), bool)
        leaf_ref = np.zeros((Tb, L), np.int32)
        for t in range(Tb):
            for node in range(I):
                ref = r.read(header.fu_bits)
                if ref >= n_fu:
                    continue  # no-split sentinel
                ti = r.read(header.tidx_bits)
                feature[t, node] = header.used_features[ref]
                thr_value[t, node] = header.thr_table[
                    header.thr_offsets[ref] + ti]
                is_split[t, node] = True
            leaf_ref[t] = r.read_array(header.leaf_bits, L).astype(np.int32)
        if r.remaining != 0:
            raise StreamingError(
                f"TOAD112: {self.path}: tree block {i} has {r.remaining} "
                f"undecoded bits — block boundaries disagree with the trees"
            )
        pos0 = int(entry["tree_pos"])
        order = self.manifest["tree_order"]
        orig = np.asarray(order[pos0:pos0 + Tb], np.int64)
        C = int(self.manifest["n_ensembles"])
        return TreeBlock(
            index=i, tree_pos=pos0, orig_ids=orig,
            class_ids=(orig % C).astype(np.int32),
            feature=feature, thr_value=thr_value,
            is_split=is_split, leaf_ref=leaf_ref,
        )

    def blocks(self, header: PackHeader):
        """Lazily yield every block, decoded, in stream order."""
        for i in range(self.n_blocks):
            yield self.decode_block(i, header)

    def fingerprint_preds(self) -> np.ndarray:
        """The stored (n_probe, C) probe predictions, digest-verified."""
        entry = self.manifest["fingerprint"]
        blob = self._verified(entry, "fingerprint", cache_key=-2)
        return blob.view(np.float32).reshape(entry["shape"]).copy()


class StreamingModel:
    """Uniform handle returned by :func:`open_streaming`.

    ``is_streaming=True`` wraps a v4 pack: ``header``/``reader`` are live
    and :meth:`scorer` serves progressively.  For v1-v3 bundles it wraps
    the classic ``load_checked`` result (``model`` is the loaded
    :class:`~repro_torch.api.model.ToadModel`) with the same ``predict``
    surface, so callers need not care which path an artifact arrived
    through.  ``device`` is where the model lives and the scorers evaluate.
    """

    def __init__(self, *, path: str, format_version: int, is_streaming: bool,
                 device, manifest: dict | None = None,
                 reader: BlockReader | None = None,
                 header: PackHeader | None = None, model=None,
                 diagnostics: list | None = None):
        self.path = path
        self.device = device
        self.format_version = format_version
        self.is_streaming = is_streaming
        self.manifest = manifest
        self.reader = reader
        self.header = header
        self.model = model
        self.diagnostics = diagnostics or []
        self._full_scorer = None

    @property
    def n_features(self) -> int:
        if self.is_streaming:
            return int(self.header.n_features)
        return int(self.model.forest.n_features)

    @property
    def n_trees(self) -> int:
        if self.is_streaming:
            return int(self.manifest["n_trees"])
        return int(self.model.forest.n_trees)

    def scorer(self, backend: str = "packed"):
        """A fresh :class:`~repro_torch.stream.progressive.ProgressiveScorer`
        on the model's device (the ``packed`` torch traversal there unless
        the caller names ``reference``, the host numpy one)."""
        from repro_torch.stream.progressive import ProgressiveScorer

        return ProgressiveScorer(self, backend=backend)

    def predict(self, X, backend: str | None = None) -> np.ndarray:
        """Converged (n, C) predictions — every block consumed.

        For classic bundles this is exactly ``ToadModel.predict``; for a
        pack it feeds all blocks once (cached) and scores through the
        requested backend (``packed``, on the model's device, unless the
        caller names one), so the two paths are interchangeable.
        """
        if not self.is_streaming:
            return np.asarray(self.model.predict(X, backend=backend))
        if self._full_scorer is None:
            self._full_scorer = self.scorer()
            self._full_scorer.feed_all()
        return self._full_scorer.predict_scores(
            np.asarray(X, np.float32), backend=backend or "packed")


def open_streaming(path: str, verify: bool = True, device="cuda") -> StreamingModel:
    """Open any artifact for (progressive, where possible) serving.

    A ``.toadpack`` validates the manifest + header/codebook sections only
    — tree blocks are not read, their digests are checked lazily as the
    :class:`BlockReader` consumes them.  v1-v3 ``.toad``/npz bundles fall
    back to :func:`~repro_torch.api.artifact.load_checked` (full classic
    verification), so ``open_streaming`` never weakens admission.  The
    model (or the pack's scorers) live on ``device``, the card unless the
    caller asks for ``"cpu"``.
    """
    path = str(path)
    dev = resolve_device(device)
    if not pack_format.is_pack(path):
        loaded = load_checked(path, verify=verify, device=dev)
        return StreamingModel(
            path=path, format_version=loaded.format_version,
            is_streaming=False, device=dev, model=loaded.model,
            diagnostics=loaded.diagnostics,
        )

    diags: list = []
    if verify:
        from repro_torch.analysis.diagnostics import errors, format_diagnostics
        from repro_torch.analysis.verify import verify_pack

        diags = verify_pack(path, deep=False)
        bad = errors(diags)
        if bad:
            raise StreamingError(
                f"{path}: streaming container verification failed "
                f"({len(bad)} error(s)):\n" + format_diagnostics(bad)
            )
    manifest = pack_format.read_manifest(path)
    reader = BlockReader(path, manifest, verify=verify)
    blob, n_bits = reader.header_blob()
    header = _parse_header(blob, n_bits, int(manifest["thr_codebook_bits"]))
    if header.n_trees != int(manifest["n_trees"]):
        raise StreamingError(
            f"TOAD114: {path}: header declares {header.n_trees} trees but "
            f"the manifest says {manifest['n_trees']}"
        )
    return StreamingModel(
        path=path, format_version=int(manifest["format_version"]),
        is_streaming=True, device=dev, manifest=manifest, reader=reader,
        header=header,
        diagnostics=[d for d in diags if d.severity != "error"],
    )
