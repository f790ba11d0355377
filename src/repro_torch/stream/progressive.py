"""Progressive scoring: answer after the first block, converge to exact.

A boosted score is a sum over trees, so a partially-streamed model is a
usable model: :class:`ProgressiveScorer` accumulates per-block partial sums
(the anytime-inference property of arxiv 2306.09789) and surfaces
``blocks_evaluated`` / ``score_is_final`` on every response.  Because the
``.toadpack`` stores trees most-informative-first, the early partial sums
already carry most of the score mass.

Multiclass correctness under permutation: tree *t* of a round-major forest
belongs to class ``t % C`` **by original index**.  Each decoded block
carries ``class_ids = tree_order[pos] % C``, so a streamed tree always
accumulates into the class it was trained for — converged progressive
scores equal ``predict_raw`` for *any* ``tree_order`` permutation.

:class:`ProgressiveModel` adapts a streaming artifact to the fleet
contract (``predictor``/``forest.n_features``/``is_compressed``), feeding
remaining blocks from a background thread so an N-model rollout serves
each model as soon as its first block lands.

The port's copy of ``repro.stream.progressive``.  The ``packed`` backend
(the default here, and what ``auto``, ``pallas`` and ``cuda`` map to) is a
torch traversal of each block's trees on the scorer's device, the block's
tensors placed there as it is fed; the ``reference`` backend, run only
when the caller names it, is the JAX package's host numpy traversal.  Partial sums are float64, each block's trees added to their
class columns (``class_ids``) in block order, as the JAX package's
``np.add.at`` adds them.  As in the JAX package, each ``predict`` walks
every block fed so far, so ``feed_until_confident`` evaluates
O(blocks²) blocks.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch._device import host


# --------------------------------------------------------------------------
# Per-block evaluation (reference = host numpy, packed = torch on a device)
# --------------------------------------------------------------------------


def _block_values_np(block, x: np.ndarray) -> np.ndarray:
    """(n, Tb) leaf values of one block on raw inputs — host numpy path."""
    n = x.shape[0]
    Tb, I = block.feature.shape
    depth = int(np.log2(I + 1))
    rows = np.arange(n)
    out = np.zeros((n, Tb), np.float32)
    for j in range(Tb):
        idx = np.zeros(n, np.int64)
        for _ in range(depth):
            f = block.feature[j, idx]
            split = block.is_split[j, idx]
            thr = block.thr_value[j, idx]
            xv = x[rows, np.maximum(f, 0)]
            go_left = np.where(split, xv <= thr, True)
            idx = 2 * idx + np.where(go_left, 1, 2)
        out[:, j] = block.leaf_values_view[block.leaf_ref[j, idx - I]]
    return out


def _block_values_torch(x, feature, thr_value, is_split, leaf_ref, leaf_values,
                        *, max_depth: int) -> torch.Tensor:
    """Same traversal vectorized over the block's trees, on ``x``'s device:
    (n, Tb) float32 leaf values."""
    Tb, I = feature.shape
    n = x.shape[0]
    tree_ix = torch.arange(Tb, device=x.device)[None, :]
    idx = torch.zeros((n, Tb), dtype=torch.int64, device=x.device)
    for _ in range(max_depth):
        f = feature[tree_ix, idx]
        split = is_split[tree_ix, idx]
        thr = thr_value[tree_ix, idx]
        xv = torch.gather(x, 1, f.clamp(min=0))
        go_left = torch.where(split, xv <= thr, True)
        idx = 2 * idx + torch.where(go_left, 1, 2)
    return leaf_values[leaf_ref[tree_ix, idx - I]]


@dataclasses.dataclass
class _DeviceBlock:
    """A fed block's tensors on the scorer's device."""

    feature: torch.Tensor    # (Tb, I) int64
    thr_value: torch.Tensor  # (Tb, I) float32
    is_split: torch.Tensor   # (Tb, I) bool
    leaf_ref: torch.Tensor   # (Tb, L) int64
    class_ids: torch.Tensor  # (Tb,) int64


@dataclasses.dataclass
class ProgressiveResult:
    """One progressive response: scores + how final they are.

    Two distinct kinds of "final": ``score_is_final`` means every block was
    fed, so the *scores* equal the classic path numerically (block-count
    semantics — pinned by a regression test, existing callers key retries
    off it).  ``decision_is_final`` additionally covers decision-finality:
    an early-exit policy proved the *labels* can no longer change even
    though blocks remain.  ``exit_reason`` says which way the evaluation
    stopped: ``"complete"`` (all blocks), ``"margin"`` (bound-based exit),
    ``"max_trees"`` (policy cap — guarantee forfeited), or ``"partial"``
    (neither — a plain mid-stream snapshot).
    """

    scores: np.ndarray        # (n, C) float32 partial (or final) sums
    blocks_evaluated: int
    n_blocks: int
    trees_evaluated: int
    score_is_final: bool
    exit_reason: str = "partial"
    decision_is_final: bool = False


class ProgressiveScorer:
    """Partial-sum scorer over a streaming artifact's tree blocks.

    ``feed_next()``/``feed_all()`` pull blocks through the
    :class:`~repro_torch.stream.reader.BlockReader` (digest-checked, lazily);
    ``predict`` evaluates every block fed *so far* plus the base score, so
    the same scorer answers immediately after the first block and converges
    to the classic-path predictions once ``score_is_final``.  Thread-safe:
    one thread may feed while others predict.  The ``packed`` backend (the
    default) evaluates on the streaming model's device; scores come back as
    host numpy, as in the JAX package.
    """

    def __init__(self, streaming_model, backend: str = "packed"):
        if not streaming_model.is_streaming:
            raise ValueError(
                "ProgressiveScorer needs a v4 streaming artifact; classic "
                "bundles already load whole — use StreamingModel.predict"
            )
        self._sm = streaming_model
        self._reader = streaming_model.reader
        self._header = streaming_model.header
        self.backend = backend
        self.n_blocks = int(streaming_model.manifest["n_blocks"])
        self._blocks: list = []
        self._lock = threading.Lock()
        self._error: Exception | None = None
        self._t0 = time.perf_counter()
        self._ttfp_ms: float | None = None
        self.device = streaming_model.device
        h = self._header
        self._leaf_values = torch.from_numpy(h.leaf_values).to(self.device)
        self._base = torch.from_numpy(h.base_score.astype(np.float64)).to(self.device)

    def use_leaf_values(self, table: torch.Tensor) -> None:
        """Resolve leaf refs against ``table``, the header's leaf values on
        the scorer's device (a fleet's shared copy), in place of the
        scorer's own copy."""
        own = self._leaf_values
        if (table.device != own.device or table.dtype != own.dtype
                or table.shape != own.shape):
            raise ValueError(f"leaf table {table.dtype} {tuple(table.shape)} on "
                             f"{table.device} does not replace {own.dtype} "
                             f"{tuple(own.shape)} on {own.device}")
        self._leaf_values = table

    # ------------------------------------------------------------- feeding
    def feed_next(self) -> bool:
        """Decode + admit the next block; False once every block landed."""
        with self._lock:
            nxt = len(self._blocks)
        if nxt >= self.n_blocks:
            return False
        try:
            block = self._reader.decode_block(nxt, self._header)
        except Exception as e:
            with self._lock:
                self._error = e
            raise
        # the numpy path resolves leaf refs against the (possibly interned)
        # shared table at eval time; stash the view the block should use
        block.leaf_values_view = self._header.leaf_values
        # the packed path's tensors land on the device with the block
        dev = self.device
        block.on_device = _DeviceBlock(
            feature=torch.from_numpy(block.feature).to(dev, torch.int64),
            thr_value=torch.from_numpy(block.thr_value).to(dev),
            is_split=torch.from_numpy(block.is_split).to(dev),
            leaf_ref=torch.from_numpy(block.leaf_ref).to(dev, torch.int64),
            class_ids=torch.from_numpy(block.class_ids).to(dev, torch.int64),
        )
        with self._lock:
            self._blocks.append(block)
        return True

    def feed_all(self) -> "ProgressiveScorer":
        while self.feed_next():
            pass
        return self

    # ------------------------------------------------------------ scoring
    @property
    def blocks_evaluated(self) -> int:
        with self._lock:
            return len(self._blocks)

    @property
    def score_is_final(self) -> bool:
        return self.blocks_evaluated >= self.n_blocks

    def predict(self, X, backend: str | None = None) -> ProgressiveResult:
        """(n, d) raw floats -> partial-sum scores over the blocks so far."""
        with self._lock:
            if self._error is not None:
                raise self._error
            blocks = list(self._blocks)
        be = backend or self.backend
        if be in (None, "auto", "pallas", "cuda"):
            be = "packed"
        if be == "reference":
            x = np.ascontiguousarray(host(X).astype(np.float32, copy=False))
            if x.ndim == 1:
                x = x[None, :]
            scores = np.tile(self._header.base_score[None, :].astype(np.float64),
                             (x.shape[0], 1))
            for block in blocks:
                values = _block_values_np(block, x).astype(np.float64)
                np.add.at(scores.T, block.class_ids, values.T)
        else:
            from repro_torch.kernels.ops import as_rows

            x = as_rows(X, self.device)
            if x.ndim == 1:
                x = x[None, :]
            acc = self._base[None, :].expand(x.shape[0], -1).clone()
            for block in blocks:
                dev = block.on_device
                values = _block_values_torch(
                    x, dev.feature, dev.thr_value, dev.is_split, dev.leaf_ref,
                    self._leaf_values, max_depth=self._header.max_depth)
                acc.index_add_(1, dev.class_ids, values.to(torch.float64))
            scores = host(acc)
        trees = sum(block.n_trees for block in blocks)
        if self._ttfp_ms is None and (blocks or self.n_blocks == 0):
            self._ttfp_ms = (time.perf_counter() - self._t0) * 1e3
        final = len(blocks) >= self.n_blocks
        return ProgressiveResult(
            scores=scores.astype(np.float32),
            blocks_evaluated=len(blocks),
            n_blocks=self.n_blocks,
            trees_evaluated=trees,
            score_is_final=final,
            exit_reason="complete" if final else "partial",
            decision_is_final=final,
        )

    def predict_scores(self, X, backend: str | None = None) -> np.ndarray:
        return self.predict(X, backend=backend).scores

    def feed_until_confident(self, X, policy,
                             backend: str | None = None) -> ProgressiveResult:
        """Feed blocks only until the partial sums are decision-final for X.

        Uses the manifest's early-exit ``remaining_mass`` bound table (the
        compress-time suffix bound for the pack's tree order): after each
        block, if every row of ``X`` satisfies
        :func:`repro_torch.gbdt.early_exit.decision_final_mask`, stop pulling —
        the labels provably equal the converged ones.  Respects the
        policy's ``min_trees``/``max_trees`` and returns a
        :class:`ProgressiveResult` whose ``exit_reason`` says why feeding
        stopped.  Blocks already fed (e.g. by the background feeder) count
        toward the prefix.
        """
        from repro_torch.gbdt.early_exit import decision_final_mask

        ee = self._sm.manifest.get("early_exit") or {}
        table = ee.get("remaining_mass")
        if table is None:
            raise ValueError(
                "this .toadpack has no early_exit bound table; re-export it "
                "with repro_torch.api.save_streaming (format writes the table "
                "unconditionally since early-exit landed)"
            )
        bound = np.asarray(table, np.float64)
        C = self._header.n_ensembles
        K = int(self._sm.manifest["n_trees"])
        if bound.shape != (K + 1, C):
            raise ValueError(
                f"early_exit bound table shape {bound.shape} != {(K + 1, C)}")
        slack = policy.slack(C)
        max_trees = K if policy.max_trees is None else min(
            int(policy.max_trees), K)

        while True:
            res = self.predict(X, backend=backend)
            if res.score_is_final:
                return res  # exit_reason "complete" already set
            k = res.trees_evaluated
            if (not policy.never_exits and k >= policy.min_trees
                    and k < K):
                fin = decision_final_mask(
                    res.scores.astype(np.float64), bound[k], slack,
                    policy.guard)
                if bool(np.all(fin)):
                    return dataclasses.replace(
                        res, exit_reason="margin", decision_is_final=True)
            if k >= max_trees:
                return dataclasses.replace(res, exit_reason="max_trees")
            if not self.feed_next():
                # another thread fed the tail between predict and here;
                # next predict sees score_is_final
                continue

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """EngineStats-style snapshot for fleet reporting."""
        with self._lock:
            n = len(self._blocks)
            trees = sum(b.n_trees for b in self._blocks)
        return {
            "time_to_first_prediction_ms": self._ttfp_ms,
            "blocks_evaluated": n,
            "n_blocks": self.n_blocks,
            "trees_evaluated": trees,
            "score_is_final": n >= self.n_blocks,
            "backend": self.backend,
        }


@dataclasses.dataclass(frozen=True)
class _ForestView:
    """The forest-shaped facts a fleet needs, without the dense arrays."""

    n_trees: int
    n_features: int
    n_ensembles: int


class ProgressiveModel:
    """A streaming artifact behind the fleet's model contract.

    Admission decodes the first block synchronously (so the model answers
    from the moment it is registered) and, with ``background=True``, feeds
    the rest from a daemon thread; ``background=False`` blocks until the
    model is complete (classic semantics on the new container).
    """

    is_streaming_model = True
    is_compressed = True
    #: set by the registry so generic code paths see no encoded stream
    encoded = None
    decoded = None
    packed = None

    def __init__(self, streaming_model, *, background: bool = True):
        from repro_torch.core.pipeline import CompressionSpec

        self._sm = streaming_model
        self.scorer = ProgressiveScorer(streaming_model)
        manifest = streaming_model.manifest
        self.spec = (CompressionSpec.from_dict(manifest["spec"])
                     if manifest.get("spec") else None)
        self.thr_codebook_bits = int(manifest["thr_codebook_bits"])
        self.artifact_meta = {
            "format_version": int(manifest["format_version"]),
            "compressed": True,
            "spec": manifest.get("spec"),
            "manifest": {
                "n_trees": int(manifest["n_trees"]),
                "n_features": int(manifest["n_features"]),
                "n_ensembles": int(manifest["n_ensembles"]),
                "thr_codebook_bits": self.thr_codebook_bits,
                "encoded_stream_bytes": float(
                    manifest["header"]["n_bytes"]
                    + sum(b["n_bytes"] for b in manifest["blocks"])),
                "sections": manifest.get("sections"),
                "tree_block": int(manifest["tree_block"]),
                "n_blocks": int(manifest["n_blocks"]),
            },
            "fingerprint": manifest.get("fingerprint"),
        }
        if self.scorer.n_blocks:
            self.scorer.feed_next()  # first block lands before we return
        self._feeder: threading.Thread | None = None
        if background and not self.scorer.score_is_final:
            self._feeder = threading.Thread(
                target=self._feed_rest, name="toadpack-feed", daemon=True)
            self._feeder.start()
        elif not background:
            self.scorer.feed_all()

    def _feed_rest(self) -> None:
        try:
            self.scorer.feed_all()
        except Exception:
            pass  # surfaced via scorer._error on the next predict

    # ----------------------------------------------------- model contract
    @property
    def forest(self) -> _ForestView:
        h = self._sm.header
        return _ForestView(n_trees=h.n_trees, n_features=h.n_features,
                           n_ensembles=h.n_ensembles)

    @property
    def header(self):
        return self._sm.header

    @property
    def device(self):
        """Where the scorer evaluates (the streaming model's device)."""
        return self._sm.device

    @property
    def manifest(self) -> dict:
        return self._sm.manifest

    def predictor(self, backend: str | None = None):
        be = "reference" if backend == "reference" else "packed"
        scorer = self.scorer

        def predict_fn(X):
            return scorer.predict_scores(X, backend=be)

        return predict_fn

    def predict(self, X, backend: str | None = None) -> np.ndarray:
        """Converged predictions (waits for every block) — the parity path."""
        self.wait_complete()
        return self.scorer.predict_scores(X, backend=backend or "packed")

    def wait_complete(self, timeout: float | None = None) -> bool:
        """Block until every tree block has been fed (True on success)."""
        if self._feeder is not None:
            self._feeder.join(timeout)
        if not self.scorer.score_is_final and self._feeder is None:
            self.scorer.feed_all()
        return self.scorer.score_is_final

    def streaming_stats(self) -> dict:
        return self.scorer.stats()

    def probe_inputs(self, n: int = 64, seed: int = 0) -> np.ndarray:
        """Deterministic (n, d) probe straddling the streamed thresholds.

        The pack carries no bin edges, so the probe is derived from the
        header's threshold table instead — same uniform-over-range recipe
        as ``core.pipeline.probe_inputs``.
        """
        h = self._sm.header
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((n, h.n_features)).astype(np.float32)
        for i, f in enumerate(h.used_features.tolist()):
            vals = h.thr_table[h.thr_offsets[i]:h.thr_offsets[i + 1]]
            if len(vals):
                lo, hi = float(vals.min()) - 1.0, float(vals.max()) + 1.0
                x[:, f] = rng.uniform(lo, hi, size=n).astype(np.float32)
        return x

    def resident_bytes(self) -> dict:
        """In-memory accounting (fleet memory report for streaming entries)."""
        h = self._sm.header
        arrays = {
            "thr_table": float(h.thr_table.nbytes),
            "leaf_values": float(h.leaf_values.nbytes),
            "thr_offsets": float(h.thr_offsets.nbytes),
            "used_features": float(h.used_features.nbytes),
        }
        if h.cb_table is not None:
            arrays["thr_codebook"] = float(h.cb_table.nbytes)
        with self.scorer._lock:
            block_bytes = float(sum(b.nbytes() for b in self.scorer._blocks))
        total = sum(arrays.values()) + block_bytes
        return {"arrays": arrays, "blocks_bytes": block_bytes,
                "n_blocks_loaded": self.scorer.blocks_evaluated,
                "total_bytes": float(total)}
