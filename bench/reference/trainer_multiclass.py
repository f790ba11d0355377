"""The reference's check of a multiclass ToaD fit (softmax, one ensemble a
class), followed node by node.

As ``reference.trainer`` does for the binary task, the reference does not
retrain: it follows the program's fit, builds every node's (g, h, count)
histograms itself in float64 from its own bins, and judges each of the
program's decisions against the best that ToaD's rule allows there (the
gain, the penalties ``ι`` and ``ξ`` against used sets that grow node by
node in commit order, ``min_child_samples``, finite edges, a live node's
left child staying live).  The rules that C classes add, as the trainer
has them:

  * the C trees of a round share the scores at the round's start:
    ``p = softmax(scores)``, and class c's ``(g, h) = (p_c − [y = c],
    2 p_c (1 − p_c))`` (XGBoost's diagonal bound); trees are round-major,
    ``r·C + c``;
  * the used sets carry from class to class and from round to round;
  * a round is taken in when its C trees split at least once in all: a
    class tree with no split inside a taken round is legal (its rows all
    reach leaf 0), a taken round with no split at all is a fault;
  * the leaf table is shared and fills: while it has room a reachable leaf
    reuses an equal stored value or appends its own, and once it is full
    the leaf takes the stored value nearest its own;
  * ``min_child_weight`` is a near tie of validity: the program sums
    hessians in float32, so a side's sum is known only to a few ulps of the
    tree's root hessian (``WEIGHT_TIE``).  A candidate whose side lies
    within that of the limit is neither required of the program nor a
    fault when taken; a split on one that the float64 rule refuses is
    counted as a ``weight_tie``;
  * a gain is a near tie to the float32 error of the program's sums
    (``gain_error``): late in a fit a node's gradient sum is a small
    difference of large per-bin sums (a class's rows against the rest),
    and a few ulps of those move its gain.  The shortfall of a choice is
    counted only beyond the error bounds of the two gains compared.

The reference's scores are the program's: its float32 base scores,
advanced in float32 by the program's stored value at each reachable leaf
(read from the program's table), as the program advances them.  So each
tree is judged on the program's own scores, and the float64 gradients and
histograms differ from the program's by float32 arithmetic alone, not by
scores summed to another precision over up to hundreds of rounds.

Compared numbers (the largest over the nodes and leaves checked):

  * ``split_regret``: how far the program's choice falls short of the best
    penalised gain (or, for a node it left unsplit, how far the best lies
    above 0), beyond the float32 error bounds of both gains, over the
    node's largest children score;
  * ``leaf_gap``: while the table has room, ``|v_program − v_reference|``
    over the larger of ``|v_reference|`` and the tree's median
    ``|v_reference|``; the base scores are held the same way;
  * ``table_regret``: once the table is full, ``|v_table − v_reference|``
    less the least ``|v − v_reference|`` over the table, on ``leaf_gap``'s
    scale (a near tie of two stored values may go either way);
  * ``tree_faults``: the sum of the kinds below.

Beside them, not compared: the faults by kind (``faults_dead``: a split at
a dead node; ``faults_invalid``: a split on an invalid candidate that is no
weight tie; ``faults_ref``: a leaf reference past the table, or a table
that does not hold what the leaves appended; ``faults_empty_round``: a
taken round with no split), ``weight_ties``, ``empty_class_trees`` (class
trees with no split inside taken rounds), ``table_full_round`` (the first
round that ends with the table full; -1 if none does) and ``worst`` (where
``split_regret`` was read).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench.reference.trainer import _histograms, _leaf_sums

#: the float32 unit roundoff of the program's sums and gains
U32 = 2.0**-24

#: a side's hessian sum within ``WEIGHT_TIE`` times the tree's root hessian
#: of ``min_child_weight`` is a near tie of validity: the program's float32
#: sums (cumulative over bins, the right side as the node's total less the
#: left, right children as the parent less the left) are exact to a few ulps
#: (2^-24) of the root's hessian, 16 of them here
WEIGHT_TIE = 2.0**-20

_KINDS = ("faults_dead", "faults_invalid", "faults_ref", "faults_empty_round")


def gain_error(GL, HL, GR, HR, tot, children, parent_term, lam, abs_g, abs_h, partial_g,
               depth):
    """A first-order bound on the float32 error of the program's gain of
    every candidate ((nodes, d, E) float64 sums of the reference).

    Each of the program's histogram cells is its exact sum rounded once,
    a right child's cell is the parent's less the left's (one more
    rounding a level, ``depth`` levels of cells on a path), the bins are
    summed in blocks (at most 64 roundings of a running sum): so a side's
    gradient sum is off by at most ``U32 (depth abs_g + 64 partial_g)``, where
    ``abs_g`` bounds every cell's magnitude summed (the tree's rows'
    ``|g| + p``) and ``partial_g`` (nodes, d) is the largest running sum of
    the node's bins; hessians likewise with ``abs_h`` (the tree's ``Σ h``)
    and the node's total.  The gain ``½(G_L²/(H_L+λ) + G_R²/(H_R+λ) −
    G²/(H+λ))`` moves by the derivatives times those errors, and by a few
    roundings of its own terms."""
    dG = U32 * (depth * abs_g + 64.0 * partial_g)[..., None]
    dH = U32 * (depth * abs_h + 64.0 * tot[:, 1])[:, None, None]
    side = lambda G, H: (2.0 * G.abs() * dG + G**2 * dH / (H + lam)) / (H + lam)
    return 0.5 * (side(GL, HL) + side(GR, HR)) + 4.0 * U32 * (children + parent_term)


def check_fit(bins, y, edges, cfg: dict, pen_f: float, pen_t: float, fit: dict,
              n_classes: int, rounds: int, chunk_rows: int = 1 << 18) -> dict:
    """Judge the first ``rounds`` rounds (``n_classes`` trees each) of the
    program's fit ``fit`` (host arrays: ``feature``, ``thr_bin``,
    ``is_split``, ``leaf_ref`` (T, ·), ``leaf_values`` (the table at its
    capacity), ``n_leaf_values``, ``n_trees``, ``base_score`` (C,),
    ``accepted`` (M,)) on the reference's own ``bins`` (n, d) uint8 and
    ``edges`` (d, E), class ids ``y`` (n,).  ``cfg`` holds the trainer's
    numbers (``reg_lambda``, ``gamma``, ``min_child_weight``,
    ``min_child_samples``, ``learning_rate``, ``max_depth``).  Returns the
    numbers of the module docstring."""
    dev = bins.device
    n, d = bins.shape
    C = int(n_classes)
    E = edges.shape[1]
    D = int(cfg["max_depth"])
    I = 2**D - 1
    L = 2**D
    lr = float(cfg["learning_rate"])
    lam = float(cfg["reg_lambda"])
    onehot = torch.nn.functional.one_hot(y.long(), C).to(torch.float64)
    base_ref = torch.log((onehot.sum(0) / n).clamp(1e-6, 1.0)).cpu().numpy()
    base_prog = np.asarray(fit["base_score"], np.float32).reshape(-1)
    scores = torch.as_tensor(base_prog, device=dev)[None, :].expand(n, C).clone()
    tree = _Tree(bins, edges, cfg, pen_f, pen_t, chunk_rows)
    table32 = np.asarray(fit["leaf_values"], np.float32)
    table = table32.astype(np.float64)
    V = len(table)
    n_table = int(fit["n_leaf_values"])
    n_trees = int(fit["n_trees"])
    out = dict(split_regret=0.0, leaf_gap=0.0, table_regret=0.0, **{k: 0 for k in _KINDS},
               weight_ties=0, empty_class_trees=0, table_full_round=-1, worst=None)
    k = 0  # values the judged leaves appended so far
    judged_rounds = min(rounds, len(fit["accepted"]))
    for r in range(judged_rounds):
        missing = (r + 1) * C > n_trees
        p = torch.softmax(scores.double(), 1)
        contribs = []
        round_split = False
        for c in range(C):
            t = r * C + c
            arrays = [np.zeros(I, np.int64), np.zeros(I, np.int64), np.zeros(I, bool)]
            if not missing:
                arrays = [np.asarray(fit[key][t], dt) for key, dt in
                          (("feature", np.int64), ("thr_bin", np.int64), ("is_split", bool))]
                round_split |= bool(arrays[2].any())
                out["empty_class_trees"] += int(not arrays[2].any())
            pc = p[:, c]
            gh = torch.stack([pc - onehot[:, c], 2.0 * pc * (1.0 - pc), torch.ones_like(pc)], 1)
            abs_g = float((gh[:, 0].abs() + pc).sum())
            pos, dead = tree.grow(gh, abs_g, *arrays, out, where=(r, c))
            if missing:
                continue
            leaf = pos - I
            sums = _leaf_sums(leaf, gh, L).cpu().numpy()
            has_rows = sums[:, 2] > 0
            value = np.where(has_rows, -lr * sums[:, 0] / (sums[:, 1] + lam), 0.0)
            ref = np.asarray(fit["leaf_ref"][t], np.int64)
            judged = has_rows & ~dead
            floor = max(float(np.median(np.abs(value[judged]))), 1e-30) if judged.any() else 1.0
            for j in np.nonzero(~dead)[0]:  # the program's order
                rj = int(ref[j])
                gap = abs(table[min(max(rj, 0), V - 1)] - value[j]) / max(abs(value[j]), floor)
                if k < V:  # room: an equal stored value, or an append
                    if not 0 <= rj <= k or rj >= n_table:
                        out["faults_ref"] += 1
                        continue
                    if rj == k:
                        k += 1
                    if judged[j]:
                        out["leaf_gap"] = max(out["leaf_gap"], gap)
                elif not 0 <= rj < V:
                    out["faults_ref"] += 1
                elif judged[j]:
                    least = np.abs(table - value[j]).min() / max(abs(value[j]), floor)
                    out["table_regret"] = max(out["table_regret"], gap - least)
            if r == 0:
                out["leaf_gap"] = max(out["leaf_gap"], abs(float(base_prog[c]) - base_ref[c])
                                      / max(abs(base_ref[c]), floor))
            stored = torch.as_tensor(table32[np.clip(ref, 0, V - 1)], device=dev)
            contribs.append(stored[leaf])
        if missing:
            break  # the trainer stops at the first round it does not take in
        if not round_split:
            out["faults_empty_round"] += 1
        if k >= V and out["table_full_round"] < 0:
            out["table_full_round"] = r
        scores += torch.stack(contribs, 1)  # float32, as the program adds
    if judged_rounds * C >= n_trees and k != n_table and not out["faults_ref"]:
        out["faults_ref"] += 1  # the table holds values that no leaf appended
    out["tree_faults"] = sum(out[kind] for kind in _KINDS)
    return out


class _Tree:
    """One tree's levels, judged node by node against float64 histograms;
    holds the used sets, which persist across trees."""

    def __init__(self, bins, edges, cfg, pen_f, pen_t, chunk_rows):
        self.bins = bins
        self.d = bins.shape[1]
        self.E = edges.shape[1]
        self.valid_edge = torch.isfinite(edges)
        self.cfg = cfg
        self.lam = float(cfg["reg_lambda"])
        self.pen_f, self.pen_t = float(pen_f), float(pen_t)
        self.chunk_rows = chunk_rows
        dev = bins.device
        self.used_feat = torch.zeros(self.d, dtype=torch.bool, device=dev)
        self.used_thr = torch.zeros((self.d, self.E), dtype=torch.bool, device=dev)

    def grow(self, gh, abs_g, feature, thr, split, out, where):
        """Route the rows through the program's tree (``feature``, ``thr``,
        ``split`` of its 2^D − 1 nodes), judging each node; returns the rows'
        final positions (n,) and the dead mask of the leaves (2^D,).
        ``abs_g``: the tree's rows' ``|g| + p`` summed (``gain_error``)."""
        bins, d, E, cfg, lam = self.bins, self.d, self.E, self.cfg, self.lam
        B = E + 1
        D = int(cfg["max_depth"])
        mcw = float(cfg["min_child_weight"])
        msc = cfg["min_child_samples"]
        n = bins.shape[0]
        pos = torch.zeros(n, dtype=torch.long, device=bins.device)
        dead = np.zeros(1, bool)
        parent = None
        tol = abs_h = 0.0
        for level in range(D):
            n_nodes = 2**level
            local = pos - (n_nodes - 1)
            if level == 0:
                hist = _histograms(bins, gh, local, 1, B, self.chunk_rows)
            else:
                left_node = torch.where(local % 2 == 0, local // 2, -1)
                left = _histograms(bins, gh, left_node, n_nodes // 2, B, self.chunk_rows)
                hist = torch.stack([left, parent - left], 1).reshape(n_nodes, d, B, 3)
            parent = hist
            cum = hist.cumsum(2)[:, :, :E]
            tot = hist[:, 0].sum(1)
            if level == 0:
                abs_h = float(tot[0, 1])
                tol = WEIGHT_TIE * max(abs_h, mcw)
            GL, HL, CL = cum[..., 0], cum[..., 1], cum[..., 2]
            GR = tot[:, None, None, 0] - GL
            HR = tot[:, None, None, 1] - HL
            CR = tot[:, None, None, 2] - CL
            children = 0.5 * (GL**2 / (HL + lam) + GR**2 / (HR + lam))
            parent_term = 0.5 * (tot[:, 0]**2 / (tot[:, 1] + lam))[:, None, None]
            gain = children - parent_term - float(cfg["gamma"])
            err = gain_error(GL, HL, GR, HR, tot, children, parent_term, lam, abs_g, abs_h,
                             torch.maximum(GL.abs().amax(-1), tot[:, None, 0].abs()), D)
            base_ok = (CL >= msc) & (CR >= msc) & self.valid_edge[None]
            lighter = torch.minimum(HL, HR)
            sure = base_ok & (lighter >= mcw + tol)  # valid to the program too
            valid = base_ok & (lighter >= mcw)  # the float64 rule
            maybe = base_ok & (lighter >= mcw - tol)  # valid to the program, maybe
            children = torch.where(maybe, children, 0.0)  # the scale: what the program may take
            for j in range(n_nodes):
                node = n_nodes - 1 + j
                pen = self.pen_f * (~self.used_feat[:, None]) + self.pen_t * (~self.used_thr)
                eff = gain[j] - pen
                best_t, at_t = torch.where(sure[j], eff, -torch.inf).view(-1).max(0)
                best, best_at, scale, best_err = torch.stack(
                    [best_t, at_t.double(), children[j].max(), err[j].view(-1)[at_t]]).tolist()
                best_at = int(best_at)
                short = 0.0
                if split[node]:
                    f, e = int(feature[node]), int(thr[node])
                    if dead[j]:
                        out["faults_dead"] += 1
                        continue
                    if not (0 <= f < d and 0 <= e < E):
                        out["faults_invalid"] += 1
                        continue
                    ok, tie, got, got_err = torch.stack(
                        [valid[j, f, e].double(), maybe[j, f, e].double(), eff[f, e],
                         err[j, f, e]]).tolist()
                    if not tie:
                        out["faults_invalid"] += 1
                        continue
                    out["weight_ties"] += int(not ok)
                    short = (max(best - best_err - got - got_err, 0.0)
                             + max(-got - got_err, 0.0))
                    self.used_feat[f] = True
                    self.used_thr[f, e] = True
                elif not dead[j]:
                    short = max(best - best_err, 0.0)
                if short > 0:
                    value = short / scale if scale > 0 else math.inf
                    if value > out["split_regret"]:
                        out["split_regret"] = value
                        out["worst"] = dict(
                            round=where[0], cls=where[1], node=node, short=short, scale=scale,
                            chosen=[int(feature[node]), int(thr[node])] if split[node] else None,
                            best=[best_at // E, best_at % E], best_gain=best)
            # a split past the features was counted above; route it on a real one
            f_n = torch.as_tensor(np.clip(feature, 0, d - 1), device=bins.device)[pos]
            e_n = torch.as_tensor(thr, device=bins.device)[pos]
            s_n = torch.as_tensor(split, device=bins.device)[pos]
            xb = bins.gather(1, f_n[:, None])[:, 0].long()
            pos = 2 * pos + torch.where(~s_n | (xb <= e_n), 1, 2)
            lvl = split[n_nodes - 1:2 * n_nodes - 1]
            dead = np.stack([dead, dead | ~lvl], 1).reshape(-1)
        return pos, dead
