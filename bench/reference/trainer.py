"""The reference's check of a ToaD fit (binary task), followed node by node.

A fit's trees are not unique: two splits whose gains tie to rounding are
both right, and after one such flip every later node differs.  So the
reference does not retrain and compare trees.  It follows the program's
fit: for each of the first ``rounds`` trees it routes the rows through the
program's splits, builds every node's (g, h, count) histograms itself in
float64 from its own bins and its own scores, and judges each of the
program's decisions against the best that ToaD's rule allows there:

  * the split gain ``Δ = ½(G_L²/(H_L+λ) + G_R²/(H_R+λ) − G²/(H+λ)) − γ``,
    less ``ι`` for a feature and ``ξ`` for a (feature, threshold) not yet
    in the global used sets, which grow node by node in commit order;
  * a candidate needs ``min_child_samples`` rows and ``min_child_weight``
    hessian on each side and a finite edge;
  * a node splits at the best candidate when its penalised gain is
    positive; the left child of an unsplit node stays live, its right
    child is dead and never splits;
  * a leaf's value is ``−lr · G / (H + λ)``.

Numbers (the largest over the nodes and leaves checked):

  * ``split_regret``: how far the program's choice falls short of the best
    penalised gain (or, for a node it left unsplit, how far the best lies
    above 0), over the node's largest children score
    ``½(G_L²/(H_L+λ) + G_R²/(H_R+λ))``;
  * ``leaf_gap``: ``|v_program − v_reference|`` over the larger of
    ``|v_reference|`` and the tree's median ``|v_reference|``; the base
    score is held the same way;
  * ``tree_faults``: splits at dead nodes or on invalid candidates, leaf
    references past the table, rounds with no split taken in, a tree
    missing while the reference finds a positive gain at its root.

The reference's scores advance by its own float64 leaf values.  Only the
program's split choices and leaf-table entries are read from the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _histograms(bins, gh, node, n_nodes, n_bins, chunk_rows):
    """(n_nodes, d, B, 3) float64 sums of ``gh`` (n, 3) by (node, feature,
    bin); rows with ``node < 0`` are left out."""
    n, d = bins.shape
    hist = torch.zeros((n_nodes * d * n_bins, 3), dtype=torch.float64, device=bins.device)
    feat = torch.arange(d, device=bins.device) * n_bins
    for lo in range(0, n, chunk_rows):
        nd = node[lo:lo + chunk_rows]
        keep = nd >= 0
        if not bool(keep.any()):
            continue
        rows = torch.nonzero(keep)[:, 0] + lo
        key = (node[rows][:, None] * (d * n_bins) + feat[None, :]
               + bins[rows].long()).reshape(-1)
        vals = gh[rows][:, None, :].expand(-1, d, 3).reshape(-1, 3)
        hist.index_add_(0, key, vals)
    return hist.view(n_nodes, d, n_bins, 3)


def _leaf_sums(node, gh, n_nodes):
    out = torch.zeros((n_nodes, 3), dtype=torch.float64, device=gh.device)
    out.index_add_(0, node, gh)
    return out


def check_fit(bins, y, edges, cfg: dict, pen_f: float, pen_t: float, fit: dict,
              rounds: int, chunk_rows: int = 1 << 17) -> dict:
    """Judge the first ``rounds`` trees of the program's fit ``fit`` (host
    arrays: ``feature``, ``thr_bin``, ``is_split``, ``leaf_ref`` (T, ·),
    ``leaf_values``, ``n_leaf_values``, ``n_trees``, ``base_score``,
    ``accepted`` (M,)) on the reference's own ``bins`` (n, d) uint8 and
    ``edges`` (d, E), labels ``y`` (n,).  ``cfg`` holds the trainer's
    numbers (``reg_lambda``, ``gamma``, ``min_child_weight``,
    ``min_child_samples``, ``learning_rate``, ``max_depth``).  Returns the
    three numbers of the module docstring."""
    dev = bins.device
    n, d = bins.shape
    E = edges.shape[1]
    B = E + 1
    D = int(cfg["max_depth"])
    I = 2**D - 1
    L = 2**D
    lam = float(cfg["reg_lambda"])
    gamma = float(cfg["gamma"])
    lr = float(cfg["learning_rate"])
    valid_edge = torch.isfinite(edges)
    y64 = y.to(torch.float64)
    p = float(y64.mean().clamp(1e-6, 1 - 1e-6))
    base = math.log(p / (1 - p))
    preds = torch.full((n,), base, dtype=torch.float64, device=dev)
    used_feat = torch.zeros(d, dtype=torch.bool, device=dev)
    used_thr = torch.zeros((d, E), dtype=torch.bool, device=dev)
    n_trees = int(fit["n_trees"])
    n_table = int(fit["n_leaf_values"])
    table = np.asarray(fit["leaf_values"], np.float64)
    regret = 0.0
    faults = 0
    leaf_gap = 0.0
    base_prog = float(np.asarray(fit["base_score"]).reshape(-1)[0])
    for t in range(min(rounds, len(fit["accepted"]))):
        missing = t >= n_trees
        feature = np.zeros(I, np.int64) if missing else np.asarray(fit["feature"][t], np.int64)
        thr = np.zeros(I, np.int64) if missing else np.asarray(fit["thr_bin"][t], np.int64)
        split = np.zeros(I, bool) if missing else np.asarray(fit["is_split"][t], bool)
        if not missing and not split.any():
            faults += 1  # a round with no split is not taken in
        s = torch.sigmoid(preds)
        gh = torch.stack([s - y64, s * (1 - s), torch.ones_like(s)], 1)
        pos = torch.zeros(n, dtype=torch.long, device=dev)
        dead = np.zeros(1, bool)
        parent = None
        for level in range(D):
            n_nodes = 2**level
            local = pos - (n_nodes - 1)
            if level == 0:
                hist = _histograms(bins, gh, local, 1, B, chunk_rows)
            else:
                left_node = torch.where(local % 2 == 0, local // 2, -1)
                left = _histograms(bins, gh, left_node, n_nodes // 2, B, chunk_rows)
                hist = torch.stack([left, parent - left], 1).reshape(n_nodes, d, B, 3)
            parent = hist
            cum = hist.cumsum(2)[:, :, :E]  # (nodes, d, E, 3): the left side of edge e
            tot = hist[:, 0].sum(1)  # (nodes, 3)
            GL, HL, CL = cum[..., 0], cum[..., 1], cum[..., 2]
            GR = tot[:, None, None, 0] - GL
            HR = tot[:, None, None, 1] - HL
            CR = tot[:, None, None, 2] - CL
            children = 0.5 * (GL**2 / (HL + lam) + GR**2 / (HR + lam))
            gain = children - 0.5 * (tot[:, 0]**2 / (tot[:, 1] + lam))[:, None, None] - gamma
            valid = ((CL >= cfg["min_child_samples"]) & (CR >= cfg["min_child_samples"])
                     & (HL >= cfg["min_child_weight"]) & (HR >= cfg["min_child_weight"])
                     & valid_edge[None])
            children = torch.where(valid, children, 0.0)
            for j in range(n_nodes):
                node = n_nodes - 1 + j
                pen = pen_f * (~used_feat[:, None]) + pen_t * (~used_thr)
                eff = torch.where(valid[j], gain[j] - pen, -torch.inf)
                best = float(eff.max())
                scale = float(children[j].max())
                if split[node]:
                    f, e = int(feature[node]), int(thr[node])
                    if dead[j] or not (0 <= f < d and 0 <= e < E) or not bool(valid[j, f, e]):
                        faults += 1
                        continue
                    got = float(eff[f, e])
                    short = max(best - got, 0.0) + max(-got, 0.0)
                    used_feat[f] = True
                    used_thr[f, e] = True
                else:
                    short = 0.0 if dead[j] else max(best, 0.0)
                if short > 0:
                    regret = max(regret, short / scale if scale > 0 else math.inf)
            # a split past the features was counted above; route it on a real one
            f_n = torch.as_tensor(np.clip(feature, 0, d - 1), device=dev)[pos]
            e_n = torch.as_tensor(thr, device=dev)[pos]
            s_n = torch.as_tensor(split, device=dev)[pos]
            xb = bins.gather(1, f_n[:, None])[:, 0].long()
            go_left = ~s_n | (xb <= e_n)
            pos = 2 * pos + torch.where(go_left, 1, 2)
            lvl = split[n_nodes - 1:2 * n_nodes - 1]
            dead = np.stack([dead, dead | ~lvl], 1).reshape(-1)
        if missing:
            break  # the trainer stops at the first round it does not take in
        leaf = pos - I
        sums = _leaf_sums(leaf, gh, L)
        value = torch.where(sums[:, 2] > 0, -lr * sums[:, 0] / (sums[:, 1] + lam), 0.0)
        ref = np.asarray(fit["leaf_ref"][t], np.int64)
        rows = (sums[:, 2] > 0).cpu().numpy() & ~dead
        if (ref[rows] >= n_table).any() or (ref[rows] < 0).any():
            faults += 1
        else:
            v_ref = value.cpu().numpy()[rows]
            v_prog = table[ref[rows]]
            if v_ref.size:
                floor = max(float(np.median(np.abs(v_ref))), 1e-30)
                gaps = np.abs(v_prog - v_ref) / np.maximum(np.abs(v_ref), floor)
                leaf_gap = max(leaf_gap, float(gaps.max()))
                if t == 0:
                    leaf_gap = max(leaf_gap, abs(base_prog - base) / max(abs(base), floor))
        preds = preds + value[leaf]
    return {"split_regret": regret, "leaf_gap": leaf_gap, "tree_faults": faults}
