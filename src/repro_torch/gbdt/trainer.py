"""Histogram GBDT with the ToaD penalties, on a device (the port's
counterpart of ``repro.gbdt.trainer``).

The same algorithm as the JAX package, step for step:

  * split gain ``Δ_l = Δ − s_f·ι − s_t·ξ`` against *global* used-feature /
    used-threshold sets that persist across trees, classes and rounds;
  * within a level, splits commit node by node, so a feature paid for by an
    earlier node is free for every later node (greedy semantics);
  * a global shared leaf-value table with exact-match (optionally
    quantized) reuse and a fixed capacity;
  * ``toad_forestsize``: the exact ToaD stream size (``core.memory.toad_bits``)
    is evaluated after every round; a round that would overflow the budget
    is reverted and training stops;
  * multiclass = one ensemble per class, trees stored round-major;
  * level-wise growth of complete trees; a node whose best penalised gain
    is not positive stays a leaf and is reconsidered through its left child.

Per level the (nodes, d, bins, 3) histograms come from
``kernels.ops.build_histogram`` (``hist_method``: ``auto``/``cuda`` = the
CUDA kernel on the card and its plain version on the CPU; ``ref``;
``fused``), with sibling subtraction at levels >= 1 (``hist_subtract``).
The leaf statistics go through the same call, as one feature of one bin, so
on the card they are the kernel's deterministic sums too.  The bins are
stored once per ``train`` call as uint8 (``n_bins <= 256``; int32 above),
row-major, the layout the kernel reads fastest: it gathers a node's rows,
and a row's slice of 16 features is one 16-byte load.

JAX's ``scan`` over rounds and ``fori_loop`` over leaves become Python
loops over tensors on the training device; its ``fori_loop`` over a level's
nodes is ``kernels.commit.commit_level``, one CUDA kernel launch a level on
the card and its plain version (the per-node loop) on the CPU.  Nothing
inside the round loop reads a value back to the host: the per-node loops
index with 0-d tensors and the round's accept/merge is ``torch.where``, so
the host only queues work.  There is no ``train_jit``: PyTorch runs eagerly and has no
jit to name.  ``train_grid`` is a loop over the grid (JAX's ``vmap``) and
equals the single runs.

Data-parallel training (``axis_name``, see ``gbdt/distributed.py``): every
rank calls ``train`` with its own rows, and the base statistics and the
row count (once a fit), every level's histogram (the left children only under sibling
subtraction) and the leaf statistics are all-reduced over the process
group, so every rank commits the same splits: one collective a level and
one for the leaves, 9 a tree at depth 8.  With ``cfg.hist_quant_bits`` (8
or 16) the reductions are ``distributed.quantized_psum`` and sibling
subtraction is off.  A data-parallel round waits for each collective; the
no-read-back rule above holds for training on one process.  CEGB's split
cost divides by the global row count (the JAX package divides by the
shard's under ``shard_map``, so its data-parallel CEGB charges the world
size times the cost: ROADMAP queue C).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch import tracing
from repro_torch.core.memory import toad_bits
from repro_torch.distributed.collectives import (
    all_reduce_count,
    all_reduce_sum,
    process_group,
    quantized_psum,
)
from repro_torch.gbdt.forest import FOREST_FIELDS, Forest
from repro_torch.gbdt.losses import make_loss
from repro_torch.kernels.commit import commit_level
from repro_torch.kernels.ops import (
    build_histogram,
    resolve_hist_method,
    sibling_subtraction_histograms,
)


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    task: str = "regression"          # regression | binary | multiclass
    n_classes: int = 0
    n_rounds: int = 64                # K boosting rounds (trees per class)
    max_depth: int = 4
    learning_rate: float = 0.1
    reg_lambda: float = 1.0           # λ
    gamma: float = 0.0                # γ per-leaf complexity
    min_child_weight: float = 1e-3
    min_child_samples: int = 1
    toad_penalty_feature: float = 0.0   # ι
    toad_penalty_threshold: float = 0.0 # ξ
    toad_forestsize: float = 0.0      # byte budget; 0 = unlimited
    leaf_capacity: int = 4096         # global leaf-value table capacity
    leaf_match_tol: float = 0.0       # reuse tolerance (0 = exact match)
    leaf_quant: float = 0.0           # optional leaf rounding grid
    cegb_penalty_split: float = 0.0   # CEGB (Peter et al.) per-split cost × n_node/n
    hist_dtype: str = "f32"           # f32 | bf16 g/h rounding (numerics
                                      # ablation); counts always exact f32
    hist_method: str = "auto"         # auto | ref | fused | cuda (kernels.ops;
                                      # the JAX package's "pallas" reads as cuda)
    hist_subtract: bool = True        # sibling subtraction at levels >= 1
    hist_quant_bits: int = 0          # 0 = exact fp32 histogram all-reduce;
                                      # 8/16 = quantized collectives
                                      # (data-parallel training only)

    @property
    def n_ensembles(self) -> int:
        return self.n_classes if self.task == "multiclass" else 1


#: the per-tree arrays of the training state, in ``_grow_tree``'s order
_TREE_KEYS = ("feature", "thr_bin", "is_split", "leaf_ref", "node_gain", "leaf_cnt")


# XLA's CPU backend evaluates jnp.cumsum and jnp.sum over the bins in these
# blocks (checked bit for bit); the port adds in the same order on every
# device, so its split gains equal the JAX package's wherever the histograms
# do.  torch.cumsum and torch.sum differ from it in the last bits (up to
# ~1e-5 on the trainer's sums), enough to flip a near tie between splits.
_SCAN_BLOCK = 16
_SUM_BLOCK = 32


def _running(blocks: torch.Tensor) -> list[torch.Tensor]:
    """Running sums along the last axis, one column at a time."""
    cols = [blocks[..., 0]]
    for i in range(1, blocks.shape[-1]):
        cols.append(cols[-1] + blocks[..., i])
    return cols


def _blocks(x: torch.Tensor, size: int) -> torch.Tensor:
    """(..., n) -> (..., ceil(n / size), size), zero-padded."""
    pad = -x.shape[-1] % size
    return torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, size)


def block_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last axis: a running sum inside
    each block of 16, then the blocks' totals summed the same way
    (recursively) and added to the following blocks."""
    n = x.shape[-1]
    out = torch.stack(_running(_blocks(x, _SCAN_BLOCK)), dim=-1)
    if out.shape[-2] > 1:
        before = torch.nn.functional.pad(block_cumsum(out[..., -1])[..., :-1], (1, 0))
        out = out + before[..., None]
    return out.reshape(*x.shape[:-1], -1)[..., :n]


def block_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis: running sums over blocks of 32, then over
    the blocks' sums (recursively).  XLA's order for lengths <= 32 and for
    multiples of 32, which covers every power-of-two bin count."""
    if x.shape[-1] <= _SUM_BLOCK:
        return _running(x)[-1]
    return block_sum(_running(_blocks(x, _SUM_BLOCK))[-1])


def _bin_storage(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The trainer's copy of the (n, d) bins: uint8 when ``n_bins <= 256``
    (4x fewer bytes than int32), row-major (contiguous)."""
    dtype = torch.uint8 if n_bins <= 256 else torch.int32
    return bins.to(dtype).contiguous()


def _grow_tree(cfg: GBDTConfig, bins, g, h, edges, state, leaf_bins, method,
               reduce_fn=None, n_rows: int | None = None):
    """Grow one complete tree level-wise.  Returns tree arrays + new state.

    state: (used_feat, used_thr, leaf_values, n_leaf, pen_f, pen_t); the
    tensors passed in are not modified.  leaf_bins: (n, 1) uint8 zeros, the
    one-bin feature the leaf statistics are histogrammed over.
    reduce_fn: cross-shard reduction of the histograms and leaf statistics
    (data-parallel training); none when None.  n_rows: the rows of every
    shard together, CEGB's denominator (default: this shard's ``n``).
    """
    used_feat, used_thr, leaf_values, n_leaf, pen_f, pen_t = state
    used_feat, used_thr = used_feat.clone(), used_thr.clone()
    dev = g.device
    n, d = bins.shape
    n_rows = n if n_rows is None else n_rows
    E = edges.shape[1]
    B = E + 1
    D = cfg.max_depth
    I = 2**D - 1
    L = 2**D
    lam = cfg.reg_lambda
    valid_edge = torch.isfinite(edges)  # (d, E)

    t_feat = torch.zeros((I,), dtype=torch.int32, device=dev)
    t_thr = torch.zeros((I,), dtype=torch.int32, device=dev)
    t_split = torch.zeros((I,), dtype=torch.bool, device=dev)
    t_gain = torch.zeros((I,), dtype=torch.float32, device=dev)  # for CCP pruning
    pos = torch.zeros((n,), dtype=torch.int64, device=dev)
    dead = torch.zeros((1,), dtype=torch.bool, device=dev)
    n_splits = torch.zeros((), dtype=torch.int32, device=dev)

    # hist_dtype="bf16" rounds g/h here (numerics ablation only);
    # accumulation stays fp32 and the count channel is exact regardless
    hdt = torch.bfloat16 if cfg.hist_dtype == "bf16" else torch.float32
    ones = torch.ones_like(g)
    gh = torch.stack([g.to(hdt).to(torch.float32), h.to(hdt).to(torch.float32), ones], -1)
    parent_hist = None

    for level in range(D):
        n_nodes = 2**level
        base_idx = n_nodes - 1

        # --- gradient/hessian/count histograms: (nodes, d, B, 3) -----------
        # data-parallel training: one all-reduce of the histogram a level
        # (left children only under sibling subtraction)
        with tracing.span("train.hist", rows=n, nodes=n_nodes):
            node_local = (pos - base_idx).to(torch.int32)  # (n,) in [0, n_nodes)
            if level >= 1 and cfg.hist_subtract:
                hist = sibling_subtraction_histograms(
                    bins, gh, node_local, parent_hist, n_bins=B, method=method,
                    reduce_fn=reduce_fn)
            else:
                hist = build_histogram(
                    bins, gh, node_local, n_nodes=n_nodes, n_bins=B, method=method)
                if reduce_fn is not None:
                    hist = reduce_fn(hist)
            parent_hist = hist

        # --- standard gain for every (node, feature, edge) ------------------
        with tracing.span("train.split"):
            left = block_cumsum(hist.movedim(-2, -1))[..., :E]  # (nodes, d, 3, E)
            GL, HL, CL = left[..., 0, :], left[..., 1, :], left[..., 2, :]
            # node totals are identical across features — reduce feature 0 once
            tot = block_sum(hist[:, 0].movedim(-2, -1))  # (nodes, 3)
            totG, totH, totC = tot[:, 0], tot[:, 1], tot[:, 2]
            GR = totG[:, None, None] - GL
            HR = totH[:, None, None] - HL
            CR = totC[:, None, None] - CL
            gain = (
                0.5 * (GL**2 / (HL + lam) + GR**2 / (HR + lam)
                       - (totG**2 / (totH + lam))[:, None, None])
                - cfg.gamma
            )
            valid = (
                (CL >= cfg.min_child_samples)
                & (CR >= cfg.min_child_samples)
                & (HL >= cfg.min_child_weight)
                & (HR >= cfg.min_child_weight)
                & valid_edge[None, :, :]
            )

        # --- sequential (greedy) commit: later nodes see earlier nodes' ----
        # --- newly used features/thresholds, per the paper's used sets  ----
        with tracing.span("train.commit", nodes=n_nodes):
            commit_level(gain, valid, totC.contiguous(), dead, pen_f, pen_t,
                         cegb=cfg.cegb_penalty_split, n_rows=n_rows, base_idx=base_idx,
                         used_feat=used_feat, used_thr=used_thr, t_feat=t_feat, t_thr=t_thr,
                         t_split=t_split, t_gain=t_gain, n_splits=n_splits)

        # --- route samples (unsplit nodes route left) -----------------------
        with tracing.span("train.route"):
            f_n = t_feat.to(torch.int64)[pos]
            e_n = t_thr[pos]
            s_n = t_split[pos]
            xb = bins.gather(1, f_n[:, None])[:, 0].to(torch.int32)
            go_left = torch.where(s_n, xb <= e_n, True)
            pos = 2 * pos + torch.where(go_left, 1, 2)

            # left child of a live unsplit node stays live (may split later once
            # penalties have been paid by other nodes); right child is dead
            split_lvl = t_split[base_idx:base_idx + n_nodes]
            dead = torch.stack([dead, dead | ~split_lvl], dim=1).reshape(-1)

    # ---------------- leaves ------------------------------------------------
    with tracing.span("train.leaves", leaves=L):
        leaf_local = (pos - (2**D - 1)).to(torch.int32)
        leaf_stats = build_histogram(
            leaf_bins, torch.stack([g, h, ones], -1), leaf_local, n_nodes=L, n_bins=1,
            method=method,
        )
        if reduce_fn is not None:
            leaf_stats = reduce_fn(leaf_stats)
        leaf_stats = leaf_stats[:, 0, 0, :]
        G_leaf, H_leaf, C_leaf = leaf_stats[:, 0], leaf_stats[:, 1], leaf_stats[:, 2]
        raw_v = torch.where(
            C_leaf > 0, -cfg.learning_rate * G_leaf / (H_leaf + lam), 0.0
        ).to(torch.float32)
        if cfg.leaf_quant > 0:
            raw_v = torch.round(raw_v / cfg.leaf_quant) * cfg.leaf_quant
        reachable = ~dead  # (L,) leaf-level liveness

        V = leaf_values.shape[0]
        slots = torch.arange(V, device=dev)
        lref = torch.zeros((L,), dtype=torch.int32, device=dev)
        for j in range(L):
            v = raw_v[j]
            diffs = torch.where(slots < n_leaf, torch.abs(leaf_values - v), torch.inf)
            dmin, best = diffs.min(0)  # first minimal index, as argmin
            match = dmin <= cfg.leaf_match_tol
            can_append = n_leaf < V
            reach = reachable[j]
            use_new = reach & ~match & can_append
            ref = torch.where(match | ~can_append, best, n_leaf)
            lref[j] = torch.where(reach, ref, 0)
            # a full table takes no append (use_new is False): clamp the slot
            appended = leaf_values.index_put((torch.clamp(n_leaf, max=V - 1).reshape(1),),
                                             v.reshape(1))
            leaf_values = torch.where(use_new, appended, leaf_values)
            n_leaf = n_leaf + use_new.to(n_leaf.dtype)

        # per-sample contribution of this tree (through the shared table, so any
        # lossy reuse is reflected in subsequent gradients)
        contrib = leaf_values[lref.to(torch.int64)[leaf_local.to(torch.int64)]]

    new_state = (used_feat, used_thr, leaf_values, n_leaf, pen_f, pen_t)
    tree = (t_feat, t_thr, t_split, lref, t_gain, C_leaf)
    return tree, contrib, n_splits, new_state


def deprecated_quant_bits(cfg: GBDTConfig, hist_quant_bits, fn: str) -> GBDTConfig:
    """``cfg`` with the DEPRECATED ``hist_quant_bits`` kwarg of ``fn`` (the
    caller's caller) applied, warning when it is passed."""
    if hist_quant_bits is None:
        return cfg
    warnings.warn(
        f"the hist_quant_bits kwarg of {fn}() is deprecated; set "
        "GBDTConfig(hist_quant_bits=...) instead",
        DeprecationWarning,
        stacklevel=3,
    )
    return dataclasses.replace(cfg, hist_quant_bits=int(hist_quant_bits))


def train(
    cfg: GBDTConfig,
    bins: torch.Tensor,
    y: torch.Tensor,
    edges: torch.Tensor,
    penalty_feature: torch.Tensor | float | None = None,
    penalty_threshold: torch.Tensor | float | None = None,
    forestsize: torch.Tensor | float | None = None,
    axis_name: str | None = None,
    hist_quant_bits: int | None = None,
):
    """Train a ToaD-regularised GBDT on ``bins``'s device.

    Args:
      cfg: configuration.  Its ``hist_quant_bits`` (0 = exact float32
        all-reduce; 8/16 = quantized histogram collectives) acts only in
        data-parallel training, as in the JAX package.
      bins: (n, d) integer pre-binned features (see ``gbdt.binning``).
      y: (n,) targets (class ids as floats for classification).
      edges: (d, E) float32 bin edges (+inf = invalid candidate).
      penalty_feature/penalty_threshold/forestsize: runtime overrides of
        ι, ξ and the byte budget (default: the cfg values).
      axis_name: data-parallel training over a ``torch.distributed``
        process group, with this rank's rows in ``bins`` and ``y``: a
        ``ProcessGroup``, or a string (the JAX package's mesh-axis name,
        such as ``"data"``) for the default group, which must be
        initialised.  Histograms, leaf statistics and base statistics are
        all-reduced so every rank grows the same trees.  None: one process.
      hist_quant_bits: DEPRECATED alias for ``cfg.hist_quant_bits``;
        overrides the config when passed.

    Returns:
      (Forest, history dict of per-round (M,) tensors, aux dict), all on
      ``bins``'s device.  Data-parallel, everything is replicated but
      ``aux["preds"]``, which holds this rank's rows.

    Spans (``repro_torch.tracing``): the call is a ``train`` root; each
    round a ``train.round`` (count ``classes``; its self time: the
    gradients, ``toad_bits``, the accept/merge and the history), each tree
    a ``train.tree``, and in a tree, per level, ``train.hist``,
    ``train.split``, ``train.commit`` and ``train.route``, then
    ``train.leaves``.
    """
    cfg = deprecated_quant_bits(cfg, hist_quant_bits, "train")
    with tracing.span("train"):
        return _train(cfg, bins, y, edges, penalty_feature, penalty_threshold, forestsize,
                      axis_name)


def _train(cfg, bins, y, edges, penalty_feature, penalty_threshold, forestsize, axis_name):
    group = process_group(axis_name)
    reduce_fn = None
    if group is not None and cfg.hist_quant_bits:
        qbits = cfg.hist_quant_bits
        reduce_fn = lambda x: quantized_psum(x, group, bits=qbits)
        # sibling subtraction would derive right children from histograms
        # that were quantized once per level, compounding quantization error
        # along right-descending paths (up to max_depth quantization events);
        # with lossy collectives, quantize each level's full histogram once
        cfg = dataclasses.replace(cfg, hist_subtract=False)
    elif group is not None:
        reduce_fn = lambda x: all_reduce_sum(x, group)
    method = resolve_hist_method(cfg.hist_method)
    dev = bins.device
    loss = make_loss(cfg.task, cfg.n_classes)
    C = loss.n_ensembles
    n, d = bins.shape
    edges = torch.as_tensor(edges, dtype=torch.float32, device=dev)
    E = edges.shape[1]
    D = cfg.max_depth
    I = 2**D - 1
    L = 2**D
    M = cfg.n_rounds
    T = M * C

    def scalar(override, default):
        value = default if override is None else override
        if isinstance(value, torch.Tensor):
            return value.to(dev, torch.float32)
        return torch.full((), float(value), dtype=torch.float32, device=dev)

    pen_f = scalar(penalty_feature, cfg.toad_penalty_feature)
    pen_t = scalar(penalty_threshold, cfg.toad_penalty_threshold)
    budget = scalar(forestsize, cfg.toad_forestsize)

    store = _bin_storage(bins, E + 1)
    leaf_bins = torch.zeros((n, 1), dtype=torch.uint8, device=dev)
    y = torch.as_tensor(y, device=dev).to(torch.float32)
    s, cnt = loss.base_stats(y)
    n_rows = n
    if group is not None:
        # the fit's two exact collectives outside the trees: the base
        # statistics, and the global row count (CEGB's denominator) as an
        # int64 sum, read back once; the float32 count is exact only to 2^24
        stats = all_reduce_sum(torch.cat([s, cnt.reshape(1)]), group)
        s, cnt = stats[:-1], stats[-1]
        n_rows = all_reduce_count(n, group, dev)
    base = loss.base_from_stats(s, cnt).to(torch.float32)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = dict(
        feature=zeros((T, I), torch.int32),
        thr_bin=zeros((T, I), torch.int32),
        is_split=zeros((T, I), torch.bool),
        leaf_ref=zeros((T, L), torch.int32),
        node_gain=zeros((T, I), torch.float32),
        leaf_cnt=zeros((T, L), torch.float32),
        leaf_values=zeros((cfg.leaf_capacity,), torch.float32),
        n_leaf=zeros((), torch.int32),
        used_feat=zeros((d,), torch.bool),
        used_thr=zeros((d, E), torch.bool),
        preds=base[None, :].expand(n, C).clone(),
        n_splits=zeros((), torch.int32),
        n_trees=zeros((), torch.int32),
        stopped=zeros((), torch.bool),
    )

    rounds = []
    for r in range(M):
        with tracing.span("train.round", classes=C):
            g_all, h_all = loss.grad_hess(y, state["preds"])
            tree_state = (state["used_feat"], state["used_thr"], state["leaf_values"],
                          state["n_leaf"], pen_f, pen_t)
            new = dict(state)
            for key in _TREE_KEYS:
                new[key] = state[key].clone()
            contribs = []
            round_splits = zeros((), torch.int32)
            for c in range(C):
                with tracing.span("train.tree"):
                    tree, contrib, n_sp, tree_state = _grow_tree(
                        cfg, store, g_all[:, c], h_all[:, c], edges, tree_state, leaf_bins,
                        method, reduce_fn, n_rows)
                for key, value in zip(_TREE_KEYS, tree):
                    new[key][r * C + c] = value
                contribs.append(contrib)
                round_splits = round_splits + n_sp
            new["used_feat"], new["used_thr"], new["leaf_values"], new["n_leaf"] = tree_state[:4]
            new["preds"] = state["preds"] + torch.stack(contribs, dim=1)
            new["n_splits"] = state["n_splits"] + round_splits
            new["n_trees"] = state["n_trees"] + C

            bits = toad_bits(new["used_feat"], new["used_thr"], new["n_leaf"],
                             new["n_trees"], new["n_splits"], edges, D, C)
            mem_ok = (budget <= 0) | (bits.to(torch.float32) <= budget * 8.0)
            accept = (~state["stopped"]) & (round_splits > 0) & mem_ok
            merged = {k: torch.where(accept, new[k], state[k]) for k in new}
            merged["stopped"] = state["stopped"] | ~accept
            rounds.append(dict(
                bytes=bits.to(torch.float32) / 8.0,
                accepted=accept,
                n_fu=torch.sum(merged["used_feat"]).to(torch.int32),
                n_thr=torch.sum(merged["used_thr"]).to(torch.int32),
                n_leaf=merged["n_leaf"],
                n_splits=merged["n_splits"],
            ))
            state = merged

    history = {k: torch.stack([h[k] for h in rounds]) if rounds else zeros((0,), v.dtype)
               for k, v in dict(bytes=torch.float32, accepted=torch.bool,
                                n_fu=torch.int32, n_thr=torch.int32,
                                n_leaf=torch.int32, n_splits=torch.int32).items()}
    forest = Forest(
        feature=state["feature"],
        thr_bin=state["thr_bin"],
        is_split=state["is_split"],
        leaf_ref=state["leaf_ref"],
        leaf_values=state["leaf_values"],
        n_leaf_values=state["n_leaf"],
        n_trees=state["n_trees"],
        edges=edges,
        base_score=base,
        n_ensembles=C,
    )
    aux = dict(
        used_feat=state["used_feat"],
        used_thr=state["used_thr"],
        preds=state["preds"],
        node_gain=state["node_gain"],
        leaf_cnt=state["leaf_cnt"],
        toad_bytes=toad_bits(state["used_feat"], state["used_thr"], state["n_leaf"],
                             state["n_trees"], state["n_splits"], edges, D, C)
        .to(torch.float32) / 8.0,
    )
    return forest, history, aux


def train_grid(cfg: GBDTConfig, bins, y, edges, pen_f_grid, pen_t_grid, forestsize_grid):
    """The paper's penalty grid searches: one trained model per grid entry.

    pen_*_grid / forestsize_grid: (G,) tensors.  A loop of :func:`train`
    (JAX's ``vmap``); the results are stacked along a leading (G,) axis,
    the layout the JAX package returns.
    """
    runs = [train(cfg, bins, y, edges, pf, pt, fs)
            for pf, pt, fs in zip(pen_f_grid, pen_t_grid, forestsize_grid)]
    forests, histories, auxes = zip(*runs)
    forest = Forest(
        **{f: torch.stack([getattr(fo, f) for fo in forests]) for f in FOREST_FIELDS},
        n_ensembles=forests[0].n_ensembles,
    )
    stack = lambda dicts: {k: torch.stack([x[k] for x in dicts]) for k in dicts[0]}
    return forest, stack(histories), stack(auxes)
