"""Baselines from the paper's Sec. 4.2 / App. D comparison (the port's
counterpart of ``repro.gbdt.baselines``).

* vanilla LightGBM-like GBDT  = trainer with penalties off, pointer layout.
* quantized LightGBM          = same model, fp16 thresholds/leaf values,
                                64 bits/node accounting.
* array-based LightGBM        = same model, pointer-less complete arrays.
* CEGB (Peter et al. 2017)    = feature-acquisition cost (coupled) + per-split
                                evaluation cost; pointer layout.
* CCP (Breiman et al. 1984)   = minimal cost-complexity post-pruning using the
                                split gains recorded during training.
* RF (+ margin&diversity pruning, Guo et al. 2018) for App. D.

The random forest grows its trees with the trainer's ``_grow_tree``, so on
the card every RF tree builds its histograms with the histogram kernel.
Its bootstrap weights and feature masks come from one seeded
``torch.Generator`` on the data's device (:func:`rf_draws`), in the JAX
package's order (one pair of draws a tree, shared by the tree's classes);
JAX's ``jax.random.PRNGKey`` stream cannot be reproduced in torch, so the
two packages' forests agree in distribution, and tree by tree only when
one package's draws are replayed through the other's grower.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pipeline import (
    codebook_leaf_values,
    codebook_thresholds,
    fp16_edges,
    fp16_leaf_values,
)
from repro_torch.gbdt.forest import Forest, forest_to_numpy, predict_binned
from repro_torch.gbdt.trainer import GBDTConfig, _bin_storage, _grow_tree
from repro_torch.kernels.ops import resolve_hist_method


# --------------------------------------------------------------------------
# Quantized LightGBM (fp16 thresholds + leaf values)
# --------------------------------------------------------------------------


def quantize_forest(forest: Forest) -> Forest:
    """fp16-round thresholds and leaf values (the paper's 'quantized' baseline).

    Composed from the compression pipeline's transforms — the same code the
    ``threshold_width`` (``threshold_precision="f16"``) and ``leaf_f16``
    stages execute, so the baseline and the pipeline cannot drift apart.
    """
    return fp16_leaf_values(fp16_edges(forest))


def shared_table_forest(forest: Forest, bits: int = 6, iters: int = 8) -> Forest:
    """LIMITS-style fully-shared-table baseline: one threshold codebook +
    one leaf codebook, both ``<= 2**bits`` entries, composed from the
    pipeline's ``threshold_codebook`` + ``leaf_codebook`` transforms."""
    shared_thr = codebook_thresholds(forest, bits=bits, iters=iters)
    return codebook_leaf_values(shared_thr, bits=bits, iters=iters)


# --------------------------------------------------------------------------
# CEGB
# --------------------------------------------------------------------------


def cegb_config(base: GBDTConfig, tradeoff: float, penalty_split: float = 0.25) -> GBDTConfig:
    """CEGB as configured against ToaD in the paper: coupled feature cost
    (paid once per new feature in the ensemble) + per-split evaluation cost
    proportional to the fraction of samples traversing the node."""
    return dataclasses.replace(
        base,
        toad_penalty_feature=tradeoff,
        toad_penalty_threshold=0.0,
        cegb_penalty_split=tradeoff * penalty_split,
    )


# --------------------------------------------------------------------------
# CCP: minimal cost-complexity pruning from recorded gains
# --------------------------------------------------------------------------


def ccp_prune(forest: Forest, node_gain, leaf_cnt, alpha: float) -> Forest:
    """Weakest-link pruning: collapse any subtree whose mean gain per split
    is <= alpha.  Host-side (numpy); leaf values of a collapsed subtree are
    merged (count-weighted) and appended to the global table.  Returns a
    forest on ``forest``'s device.

    Args:
      forest: trained ensemble.
      node_gain: (T, I) recorded split gains (aux['node_gain']).
      leaf_cnt: (T, L) training sample counts per leaf (aux['leaf_cnt']).
      alpha: complexity parameter.
    """
    a = forest_to_numpy(forest)
    K = int(a["n_trees"])
    split = a["is_split"].copy()
    lref = a["leaf_ref"].copy()
    gains = np.asarray(torch.as_tensor(node_gain).cpu())
    cnts = np.asarray(torch.as_tensor(leaf_cnt).cpu())
    table = list(a["leaf_values"])
    I = split.shape[1]

    def leaf_stats(t, node):
        """(weighted value sum, count) over reachable leaves under ``node``."""
        if node >= I:  # leaf slot
            j = node - I
            v = table[lref[t, j]]
            c = cnts[t, j]
            return v * c, c
        if not split[t, node]:
            # unsplit internal: everything routes left
            return leaf_stats(t, 2 * node + 1)
        lv, lc = leaf_stats(t, 2 * node + 1)
        rv, rc = leaf_stats(t, 2 * node + 2)
        return lv + rv, lc + rc

    def prune(t, node):
        """Returns (subtree gain sum, subtree split count) after pruning."""
        if node >= I or not split[t, node]:
            if node < I:
                # keep following the live left chain
                return prune(t, 2 * node + 1)
            return 0.0, 0
        gl, nl = prune(t, 2 * node + 1)
        gr, nr = prune(t, 2 * node + 2)
        g = gains[t, node] + gl + gr
        ns = 1 + nl + nr
        if g / ns <= alpha:
            # collapse: merged value goes to the leftmost reachable leaf slot
            vsum, csum = leaf_stats(t, node)
            merged = vsum / max(csum, 1e-9)
            stack = [node]
            while stack:
                m = stack.pop()
                if m < I:
                    if split[t, m]:
                        stack.extend([2 * m + 1, 2 * m + 2])
                    split[t, m] = False
            leftmost = node
            while leftmost < I:
                leftmost = 2 * leftmost + 1
            table.append(np.float32(merged))
            lref[t, leftmost - I] = len(table) - 1
            return 0.0, 0
        return g, ns

    for t in range(K):
        prune(t, 0)

    dev = forest.device
    put = lambda x, dtype: torch.from_numpy(np.asarray(x, dtype)).to(dev)
    return dataclasses.replace(
        forest,
        is_split=put(split, np.bool_),
        leaf_ref=put(lref, np.int32),
        leaf_values=put(table, np.float32),
        n_leaf_values=put(len(table), np.int32),
    )


# --------------------------------------------------------------------------
# Random forest (App. D)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RFConfig:
    task: str = "binary"
    n_classes: int = 0
    n_trees: int = 64
    max_depth: int = 4
    feature_fraction: float = 0.7
    reg_lambda: float = 1e-3
    min_child_samples: int = 1

    @property
    def n_ensembles(self) -> int:
        return self.n_classes if self.task == "multiclass" else 1


def rf_draws(cfg: RFConfig, n: int, d: int, seed: int = 0, device="cpu"):
    """The random forest's draws, tree by tree: ``(w, keep)`` with ``w``
    (n,) float32 Poisson(1) bootstrap weights and ``keep`` (d,) bool the
    features the tree may split on (``uniform < feature_fraction``), from
    one ``torch.Generator`` on ``device`` seeded with ``seed``: per tree the
    weights, then the mask."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rate = torch.ones((n,), dtype=torch.float32, device=device)
    for _ in range(cfg.n_trees):
        w = torch.poisson(rate, generator=gen)
        keep = torch.rand((d,), generator=gen, device=device) < cfg.feature_fraction
        yield w, keep


def train_rf(cfg: RFConfig, bins, y, edges, seed: int = 0):
    """Bagged trees: Poisson(1) bootstrap weights + per-tree feature masks
    (:func:`rf_draws`, on ``bins``'s device).

    Each tree fits the (weighted) target mean per leaf, which is recovered
    from the GBDT grower with g = -w*y, h = w, lr = 1.  Classification
    trains one probability ensemble per class (one-vs-rest), predictions
    are averaged over trees.  Returns ``(forest, n_splits)``.
    """
    gcfg = GBDTConfig(
        task="regression",
        n_rounds=1,
        max_depth=cfg.max_depth,
        learning_rate=1.0,
        reg_lambda=cfg.reg_lambda,
        min_child_samples=cfg.min_child_samples,
        leaf_capacity=cfg.n_trees * (2**cfg.max_depth) * max(cfg.n_ensembles, 1),
    )
    dev = bins.device
    n, d = bins.shape
    edges = torch.as_tensor(edges, dtype=torch.float32, device=dev)
    E = edges.shape[1]
    C = cfg.n_ensembles
    L = 2**cfg.max_depth
    y = torch.as_tensor(y, device=dev)
    if cfg.task == "multiclass":
        targets = torch.nn.functional.one_hot(y.long(), C).to(torch.float32)
    else:
        targets = y.to(torch.float32)[:, None]

    store = _bin_storage(bins, E + 1)
    leaf_bins = torch.zeros((n, 1), dtype=torch.uint8, device=dev)
    method = resolve_hist_method(gcfg.hist_method)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    trees = []
    n_splits = torch.zeros((), dtype=torch.int64, device=dev)
    for w, keep in rf_draws(cfg, n, d, seed, device=dev):
        masked_edges = torch.where(keep[:, None], edges, torch.inf)
        for c in range(C):
            state = (
                torch.zeros((d,), dtype=torch.bool, device=dev),
                torch.zeros((d, E), dtype=torch.bool, device=dev),
                torch.zeros((L,), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                zero,
                zero,
            )
            tree, _, n_sp, state = _grow_tree(
                gcfg, store, -w * targets[:, c], w, masked_edges, state, leaf_bins, method)
            t_feat, t_thr, t_split, lref = tree[:4]
            trees.append((t_feat, t_thr, t_split, state[2][lref.long()]))
            n_splits += n_sp

    Tn = len(trees)
    stack = lambda k: torch.stack([t[k] for t in trees])
    # a flat value table (no sharing for RF): tree t's leaves at t*L..t*L+L-1
    forest = Forest(
        feature=stack(0),
        thr_bin=stack(1),
        is_split=stack(2),
        leaf_ref=torch.arange(Tn * L, dtype=torch.int32, device=dev).reshape(Tn, L),
        leaf_values=stack(3).reshape(-1),
        n_leaf_values=torch.tensor(Tn * L, dtype=torch.int32, device=dev),
        n_trees=torch.tensor(Tn, dtype=torch.int32, device=dev),
        edges=edges,
        base_score=torch.zeros((C,), dtype=torch.float32, device=dev),
        n_ensembles=C,
    )
    return forest, int(n_splits)


def rf_predict(forest: Forest, bins) -> torch.Tensor:
    """Average (not sum) of tree outputs, as RF does."""
    total = predict_binned(forest, bins)
    n_per_class = max(int(forest.n_trees) // forest.n_ensembles, 1)
    return total / n_per_class


def rf_bits(n_splits: int, n_trees: int, n_classes: int = 1) -> int:
    """Pointer layout; RF leaves store the per-class distribution, so each
    leaf pays (C-1) extra fp32 values relative to the boosted accounting."""
    leaves = n_splits + n_trees
    return (2 * n_splits + n_trees) * 128 + leaves * 32 * max(n_classes - 1, 0)


def margin_diversity_order(tree_preds: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Guo et al. (2018) style margin&diversity ensemble ordering.

    tree_preds: (T, n) per-tree predicted class id (or sign for binary).
    Returns tree indices in selection order; keep a prefix to prune.
    """
    T, n = tree_preds.shape
    correct = (tree_preds == y[None, :]).astype(np.float64)
    chosen: list[int] = []
    remaining = set(range(T))
    votes = np.zeros(n)
    for _ in range(T):
        best, best_score = None, -np.inf
        for t in remaining:
            new_votes = votes + 2 * correct[t] - 1
            margin = np.mean(np.tanh(new_votes / max(len(chosen) + 1, 1)))
            div = 1.0 - (np.mean(correct[t] == (votes > 0)) if chosen else 0.0)
            score = margin + 0.1 * div
            if score > best_score:
                best, best_score = t, score
        chosen.append(best)
        remaining.discard(best)
        votes += 2 * correct[best] - 1
    return np.asarray(chosen)


def take_trees(forest: Forest, idx) -> Forest:
    """Subset/reorder trees (used by ensemble pruning)."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=forest.device)
    return dataclasses.replace(
        forest,
        feature=forest.feature[idx],
        thr_bin=forest.thr_bin[idx],
        is_split=forest.is_split[idx],
        leaf_ref=forest.leaf_ref[idx],
        n_trees=torch.tensor(len(idx), dtype=torch.int32, device=forest.device),
    )
