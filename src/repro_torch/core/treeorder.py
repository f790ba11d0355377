"""Tree ordering + remaining-score-mass bounds (a copy of
``repro.core.treeorder``).

A boosted score is a sum over trees, so two serving optimizations reduce to
the same per-tree statistic — how much score a tree can contribute, taken
over the leaves a traversal can actually *reach* (unsplit nodes route left,
so right subtrees under unsplit/dead nodes never fire):

* the ``.toadpack`` streaming order sorts trees by descending reachable
  |leaf-value| mass, so a cold-start client decodes the largest
  contributions first;
* adaptive early exit (:mod:`repro_torch.gbdt.early_exit`, arxiv
  2306.09789) stops evaluating once the leading-class margin exceeds what
  the remaining trees could still move the score — bounded per class by the
  suffix sum of per-tree max reachable |leaf value|.

Host-side numpy on anything forest-shaped (``n_trees`` / ``is_split`` /
``leaf_ref`` / ``leaf_values`` / ``n_ensembles`` — a
:class:`~repro_torch.gbdt.forest.Forest` on any device, a bundle's raw
arrays, or a decoded stream).  All sums are float64 and the suffix
accumulation order is the JAX package's, so a bound table computed here is
bit-identical to the one ``repro`` computes from the same forest — which is
what the toadcheck TOAD120 check of a bundle written by the port relies on.
"""

from __future__ import annotations

import numpy as np

from repro_torch._device import host


def _tree_views(forest):
    """(K, is_split[:K], leaf_ref[:K], leaf_values) as host numpy arrays."""
    K = int(forest.n_trees)
    is_split = host(forest.is_split)[:K]
    leaf_ref = host(forest.leaf_ref)[:K]
    leaf_values = host(forest.leaf_values)
    return K, is_split, leaf_ref, leaf_values


def reachable_leaf_mask(is_split: np.ndarray) -> np.ndarray:
    """(K, L) bool: which leaf slots a traversal can actually reach.

    Unsplit nodes route left, so the right subtree of an unsplit (or dead)
    node is unreachable — the same propagation the structural verifier uses
    for TOAD010, extended one level down to the leaf row.
    """
    K, I = is_split.shape
    L = I + 1
    dead = np.zeros((K, I), bool)
    for i in range(1, I):
        p = (i - 1) // 2
        dead[:, i] = dead[:, p] | ((i % 2 == 0) & ~is_split[:, p])
    reach = np.ones((K, L), bool)
    for j in range(L):
        node = I + j
        p = (node - 1) // 2
        reach[:, j] = ~dead[:, p] & ((node % 2 == 1) | is_split[:, p])
    return reach


def reachable_leaf_abs(forest) -> np.ndarray:
    """(K, L) float64 |leaf value| per slot, zero where unreachable."""
    K, is_split, leaf_ref, leaf_values = _tree_views(forest)
    if K == 0:
        return np.zeros((0, leaf_ref.shape[1] if leaf_ref.ndim == 2 else 1))
    reach = reachable_leaf_mask(is_split)
    return np.where(reach, np.abs(leaf_values[leaf_ref].astype(np.float64)), 0.0)


def tree_mass(forest) -> np.ndarray:
    """(K,) float64: total reachable |leaf value| mass per tree.

    The streaming order's sort key — a proxy for how much score the tree
    contributes across inputs.
    """
    return reachable_leaf_abs(forest).sum(axis=1)


def tree_max_step(forest) -> np.ndarray:
    """(K,) float64: max reachable |leaf value| per tree.

    The early-exit bound's per-tree term: one traversal lands in exactly
    one reachable leaf, so a tree moves its class score by at most this.
    """
    absv = reachable_leaf_abs(forest)
    if absv.shape[0] == 0:
        return np.zeros(0)
    return absv.max(axis=1, initial=0.0)


def tree_order_most_informative(forest) -> np.ndarray:
    """Permutation of ``range(n_trees)``: descending reachable leaf mass.

    Ties break on the original index (stable), so the order is
    deterministic for a given forest.
    """
    K = int(forest.n_trees)
    if K == 0:
        return np.zeros(0, np.int64)
    return np.argsort(-tree_mass(forest), kind="stable").astype(np.int64)


def suffix_bound(step: np.ndarray, class_ids: np.ndarray,
                 n_ensembles: int) -> np.ndarray:
    """(K+1, C) float64 suffix sums of per-position steps, split by class.

    ``bound[k, c] = sum(step[p] for p in [k, K) if class_ids[p] == c)`` —
    an upper bound on how much stream positions ``k..K-1`` can still move
    the class-c score.  Row ``K`` is all zeros and every column is monotone
    non-increasing in ``k`` by construction (steps are non-negative).
    """
    step = np.asarray(step, np.float64)
    class_ids = np.asarray(class_ids, np.int64)
    K = step.shape[0]
    C = int(n_ensembles)
    out = np.zeros((K + 1, C), np.float64)
    if K == 0:
        return out
    if np.any(step < 0):
        raise ValueError("suffix_bound needs non-negative per-tree steps")
    for c in range(C):
        contrib = np.where(class_ids == c, step, 0.0)
        out[:K, c] = np.cumsum(contrib[::-1])[::-1]
    return out


def remaining_mass(forest, tree_order: np.ndarray | None = None) -> np.ndarray:
    """(K+1, C) float64 early-exit bound table for a tree evaluation order.

    Entry ``[k, c]`` bounds how much the trees at stream positions
    ``k..K-1`` (``tree_order[p]`` = original tree index at position ``p``;
    default: original order) can still move the class-c score for *any*
    input: the class-split suffix sum of each tree's max reachable
    |leaf value|.  Multiclass trees keep their class identity through the
    permutation (class of position ``p`` is ``tree_order[p] % C``), same
    as the streaming scorer.
    """
    K = int(forest.n_trees)
    C = int(getattr(forest, "n_ensembles", 1))
    if tree_order is None:
        order = np.arange(K, dtype=np.int64)
    else:
        order = np.asarray(tree_order, np.int64)
        if sorted(order.tolist()) != list(range(K)):
            raise ValueError(f"tree_order must be a permutation of range({K})")
    step = tree_max_step(forest)[order] if K else np.zeros(0)
    return suffix_bound(step, order % max(C, 1), C)
