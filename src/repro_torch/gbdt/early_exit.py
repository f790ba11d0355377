"""Adaptive early-exit inference with provably-sound margin bounds (a copy
of ``repro.gbdt.early_exit``).

Boosted scores are partial sums, so evaluation can stop at prefix length
``k`` once no suffix of trees can overturn the current decision (Dynamic
Decision Tree Ensembles, arxiv 2306.09789).  The bound comes from
:func:`repro_torch.core.treeorder.remaining_mass` — for each prefix length
and class, the suffix sum of per-tree max reachable |leaf value| — which is
shipped in the ``.toad`` meta (``api.artifact``).

The soundness contract: **a row that exits keeps exactly the
``predict_label`` of the full ensemble** — not within a tolerance.  Ties
with the bound itself do not exit (strict inequality), and a relative
``guard`` widens the required margin to absorb the backends' ≤1e-5
score-parity slop plus float summation-order drift, so the guarantee holds
on every backend, not just the one that computed the partial sum.
``max_trees`` is the one escape hatch: it caps latency by force-exiting,
forfeiting the guarantee (off by default).

Consumers: the reference evaluator here, the CUDA early-exit kernel and its
plain version (:func:`repro_torch.kernels.predict.packed_predict_early_exit`,
:func:`repro_torch.kernels.ref.packed_predict_early_exit_ref`), and the
serving adapter (:class:`repro_torch.api.engine.EarlyExitPredictor`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch._device import host
from repro_torch.core.treeorder import remaining_mass

__all__ = [
    "EarlyExitPolicy",
    "EarlyExitResult",
    "decision_final_mask",
    "predict_early_exit",
    "predict_label_from_scores",
    "remaining_mass",
]

#: default relative margin guard — comfortably above the registry's 1e-5
#: cross-backend score parity contract, far below any real decision margin
DEFAULT_GUARD = 1e-4


def _to_num(v) -> float:
    if isinstance(v, str):
        return math.inf if v in ("inf", "Infinity") else float(v)
    return float(v)


def _from_num(v: float):
    return "inf" if math.isinf(v) else float(v)


@dataclasses.dataclass(frozen=True)
class EarlyExitPolicy:
    """When a partial boosted score is allowed to stop evaluating.

    - ``epsilon``: extra margin slack beyond the remaining-mass bound; 0 is
      already sound, larger values exit later (more conservative).  ``inf``
      disables exits entirely (full evaluation, bit-identical).
    - ``min_trees`` / ``max_trees``: clamp the exit point.  ``max_trees``
      force-exits and therefore *forfeits* the label-exactness guarantee.
    - ``per_class_epsilon``: optional per-class additional slack (length C),
      added to ``epsilon`` for the would-be winning class.
    - ``guard``: relative slop absorbing cross-backend float drift (see
      module docstring).  Setting it to 0 makes the bound exact for the
      backend that computed the scores only.
    """

    epsilon: float = 0.0
    min_trees: int = 0
    max_trees: int | None = None
    per_class_epsilon: tuple[float, ...] | None = None
    guard: float = DEFAULT_GUARD

    def __post_init__(self):
        if not (self.epsilon >= 0.0):
            raise ValueError("epsilon must be >= 0")
        if self.min_trees < 0:
            raise ValueError("min_trees must be >= 0")
        if self.max_trees is not None and self.max_trees < 1:
            raise ValueError("max_trees must be >= 1")
        if not (self.guard >= 0.0):
            raise ValueError("guard must be >= 0")
        if self.per_class_epsilon is not None:
            pce = tuple(float(v) for v in self.per_class_epsilon)
            if any(not (v >= 0.0) for v in pce):
                raise ValueError("per_class_epsilon entries must be >= 0")
            object.__setattr__(self, "per_class_epsilon", pce)

    @property
    def never_exits(self) -> bool:
        """True when no margin exit can ever fire (ε=∞ full evaluation)."""
        return math.isinf(self.epsilon)

    def slack(self, n_ensembles: int) -> np.ndarray:
        """(C,) float64 per-class slack = epsilon + per-class extra."""
        C = int(n_ensembles)
        s = np.full(C, self.epsilon, np.float64)
        if self.per_class_epsilon is not None:
            if len(self.per_class_epsilon) != C:
                raise ValueError(
                    f"per_class_epsilon has {len(self.per_class_epsilon)} "
                    f"entries for {C} classes"
                )
            s = s + np.asarray(self.per_class_epsilon, np.float64)
        return s

    def to_dict(self) -> dict:
        return {
            "epsilon": _from_num(self.epsilon),
            "min_trees": int(self.min_trees),
            "max_trees": None if self.max_trees is None else int(self.max_trees),
            "per_class_epsilon": (
                None if self.per_class_epsilon is None
                else [_from_num(v) for v in self.per_class_epsilon]
            ),
            "guard": float(self.guard),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EarlyExitPolicy":
        pce = d.get("per_class_epsilon")
        return cls(
            epsilon=_to_num(d.get("epsilon", 0.0)),
            min_trees=int(d.get("min_trees", 0)),
            max_trees=(None if d.get("max_trees") is None
                       else int(d["max_trees"])),
            per_class_epsilon=(None if pce is None
                               else tuple(_to_num(v) for v in pce)),
            guard=float(d.get("guard", DEFAULT_GUARD)),
        )


def decision_final_mask(scores, rem, slack, guard: float = 0.0):
    """(n,) bool: rows whose ``predict_label`` can no longer change.

    ``scores`` is (n, C); ``rem`` is the (C,) remaining-mass bound row for
    the current prefix; ``slack`` is (C,) policy slack.  Written with
    operators only, evaluated left to right, so the same tie rule runs on
    numpy float64 arrays (the reference evaluator) and on
    torch float32 tensors (the CUDA kernel's plain version, whose kernel
    does the same operations in the same order).

    Binary (C==1, label ``score > 0``): the sign is final when
    ``s - rem > g`` or ``s + rem <= -g``.  Multiclass (``np.argmax``,
    first-max-wins): candidate leader ``j`` is final when for every other
    class ``c`` the lead exceeds ``rem[j] + rem[c]`` plus slack — strictly
    for ``c < j`` (a tie would flip argmax to ``c``), non-strictly for
    ``c > j``.  A margin equal to the bound exactly therefore does NOT
    exit.  ``guard`` adds ``guard * (1 + |s_j| + |s_c|)`` to the required
    lead.
    """
    C = scores.shape[-1]
    if C == 1:
        s = scores[..., 0]
        g = slack[0] + guard * (1.0 + abs(s))
        r = rem[0]
        return ((s - r) > g) | ((s + r) <= -g)
    out = None
    for j in range(C):
        sj = scores[..., j]
        cond = None
        for c in range(C):
            if c == j:
                continue
            sc = scores[..., c]
            need = rem[j] + rem[c] + slack[j] + guard * (1.0 + abs(sj) + abs(sc))
            diff = sj - sc
            term = (diff > need) if c < j else (diff >= need)
            cond = term if cond is None else (cond & term)
        out = cond if out is None else (out | cond)
    return out


def predict_label_from_scores(scores: np.ndarray, task: str) -> np.ndarray:
    """Same label rule as ``ToadModel.predict_label``, from raw scores."""
    scores = host(scores)
    if task == "multiclass":
        return np.argmax(scores, axis=1).astype(np.int32)
    if task == "regression":
        return scores[:, 0]
    return (scores[:, 0] > 0).astype(np.int32)


@dataclasses.dataclass
class EarlyExitResult:
    """Scores plus per-row exit accounting from an early-exit evaluation."""

    scores: np.ndarray           # (n, C) float32 — partial where exited
    trees_evaluated: np.ndarray  # (n,) int32 stream prefix length used
    exited: np.ndarray           # (n,) bool — True where a margin exit fired
    n_trees: int                 # full ensemble size T

    @property
    def mean_trees_evaluated(self) -> float:
        if self.trees_evaluated.size == 0:
            return 0.0
        return float(self.trees_evaluated.mean())

    @property
    def frac_exited(self) -> float:
        if self.exited.size == 0:
            return 0.0
        return float(self.exited.mean())


def _tree_leaf_values(feature, thr_bin, is_split, leaf_ref,
                      leaf_values, edges, x):
    """(n,) leaf value of one tree for raw inputs ``x`` (numpy)."""
    n = x.shape[0]
    I = feature.shape[0]
    depth = int(np.log2(I + 1))
    d = edges.shape[0]
    E = edges.shape[1]
    idx = np.zeros(n, np.int64)
    rows = np.arange(n)
    for _ in range(depth):
        f = np.clip(feature[idx], 0, d - 1)
        e = np.clip(thr_bin[idx], 0, E - 1)
        split = is_split[idx]
        # bin(x) <= e  ⟺  x <= edges[f, e] for sorted edges — identical to
        # the binned reference and the packed threshold compare
        go_left = np.where(split, x[rows, f] <= edges[f, e], True)
        idx = 2 * idx + np.where(go_left, 1, 2)
    return leaf_values[leaf_ref[idx - I]]


def predict_early_exit(
    forest,
    X: np.ndarray,
    policy: EarlyExitPolicy,
    *,
    tree_order: np.ndarray | None = None,
    bound: np.ndarray | None = None,
    check_every: int = 1,
) -> EarlyExitResult:
    """Reference early-exit evaluator (numpy, row-level exits).

    Walks trees in ``tree_order`` (default: original order), accumulating
    float64 partial sums, and checks :func:`decision_final_mask` against
    the ``bound`` table (default: recomputed via :func:`remaining_mass`
    for that order) every ``check_every`` trees.  Exited rows stop being
    traversed and keep their partial scores.  This is the semantic ground
    truth the kernel, adapter and streaming paths are tested against.
    """
    X = host(X).astype(np.float32, copy=False)
    n = X.shape[0]
    K = int(forest.n_trees)
    C = int(forest.n_ensembles)
    feature = host(forest.feature)
    thr_bin = host(forest.thr_bin)
    is_split = host(forest.is_split)
    leaf_ref = host(forest.leaf_ref)
    leaf_values = host(forest.leaf_values)
    edges = host(forest.edges)
    base = host(forest.base_score).astype(np.float64)

    if tree_order is None:
        order = np.arange(K, dtype=np.int64)
    else:
        order = np.asarray(tree_order, np.int64)
    if bound is None:
        bound = remaining_mass(forest, order)
    bound = np.asarray(bound, np.float64)
    if bound.shape != (K + 1, C):
        raise ValueError(
            f"bound table shape {bound.shape} != {(K + 1, C)}"
        )
    slack = policy.slack(C)
    guard = policy.guard
    check_every = max(1, int(check_every))

    scores = np.tile(base[None, :], (n, 1))
    trees_eval = np.zeros(n, np.int32)
    exited = np.zeros(n, bool)
    active = np.arange(n)
    max_t = K if policy.max_trees is None else min(int(policy.max_trees), K)

    p = 0
    while p < max_t and active.size:
        p1 = min(p + check_every, max_t)
        for t in range(p, p1):
            tree = int(order[t])
            vals = _tree_leaf_values(
                feature[tree], thr_bin[tree], is_split[tree],
                leaf_ref[tree], leaf_values, edges, X[active],
            )
            scores[active, tree % C] += vals
        p = p1
        if policy.never_exits or p < policy.min_trees or p >= K:
            continue
        fin = decision_final_mask(scores[active], bound[p], slack, guard)
        newly = active[fin]
        trees_eval[newly] = p
        exited[newly] = True
        active = active[~fin]
    trees_eval[active] = p  # rows that never margin-exited ran to max_t

    return EarlyExitResult(
        scores=scores.astype(np.float32),
        trees_evaluated=trees_eval,
        exited=exited,
        n_trees=K,
    )
