"""Packed ToaD inference: the wrappers around the CUDA kernels.

``packed_predict`` keeps the signature of the JAX package's
``repro.kernels.predict.packed_predict`` (which runs the Pallas TPU kernel
``_kernel``), and ``packed_predict_early_exit`` that of its early-exit
variant (the Pallas kernel ``_kernel_ee``).  A CUDA tensor launches the
hand-written kernel in ``csrc/packed_predict.cu`` or
``csrc/packed_predict_ee.cu`` (built for ``sm_90a`` at first use) or
raises; a CPU tensor runs the plain version, ``kernels.ref.packed_predict_ref``
or ``kernels.ref.packed_predict_early_exit_ref``.  There is no fallback
from one to the other.

The inputs are checked the same way on both devices, so the CPU tests check
what the kernels take: x (n, d) contiguous float32; words (T, I) int32
storage of the uint32 node words; leaf_ref (T, I + 1) int32; leaf_values,
thr_table and base_score float32; thr_offsets (|F_U| + 1,) and
used_features (|F_U|,) int32, |F_U| <= 65,535; every feature index in
[0, d).  Checking the last needs the largest used feature on the host:
pass it as ``max_feature`` (``kernels.ops.DevicePacked`` does, having
checked it once) or the wrapper reads it back from the device, one sync
per call.

On the card a call first decodes the model into a buffer the wrapper
allocates (``decoded_bytes``: per node its threshold and 16-bit feature
slot, per leaf its value), and the walk reads that.  :func:`launch_plan`
chooses, by shape alone, how the kernels take a call (``csrc/packed_walk.cuh``
says why): the rows a block owns, what it stages in shared memory, and
whether ``packed_predict`` splits the tree blocks over the grid (small
batches: each block writes its tree blocks' sums to a scratch buffer the
wrapper allocates, and a last launch adds them in order).  Both kernels sum
in the Pallas kernel's block order, as the plain versions do, so a kernel
and its plain version give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (  # noqa: F401  (TREE_BLOCK: part of this module's API)
    TREE_BLOCK,
    packed_predict_early_exit_ref,
    packed_predict_ref,
    tree_block_for,
)

_launch_lock = threading.Lock()

#: blocks a call aims at: about two an SM of the H100's 132
TARGET_BLOCKS = 2 * 132
#: shared memory one block may use on sm_90, and what each staged part may take
SMEM_MAX = 232448
X_TILE_BYTES = 32 * 1024  # the row tile of used x
TREE_BYTES = 64 * 1024  # two decoded tree blocks
#: the plan's stage bits (csrc/packed_walk.cuh)
STAGE_X, STAGE_TREES = 1, 2
STAGE_NAMES = ((STAGE_X, "x"), (STAGE_TREES, "trees"))
#: the kernels keep a node's feature slot in 16 bits
MAX_USED_FEATURES = 65535
_WARPS = 8


class PredictPlan(NamedTuple):
    """How the kernels take one call: ``rows`` a block, the ``groups`` of
    tree blocks the grid splits them over (1: a block walks every tree
    block), ``per_group`` tree blocks a group, the ``stage`` bits (what a
    block keeps in shared memory), its ``smem`` bytes and the ``grid``."""

    rows: int
    groups: int
    per_group: int
    stage: int
    smem: int
    grid: tuple[int, int]

    @property
    def split(self) -> bool:
        return self.groups > 1

    def describe(self) -> str:
        staged = [name for bit, name in STAGE_NAMES if self.stage & bit]
        where = (f"split over {self.groups} groups of {self.per_group} tree block(s)"
                 if self.split else "unsplit")
        return (f"{self.rows}-row tiles, grid {self.grid}, {where}; staged: "
                f"{', '.join(staged) or 'nothing'}; {self.smem} B of shared memory")


def _r4(words: int) -> int:
    return -(-words // 4) * 4


def _tree_words(tree_block: int, I: int) -> int:
    """Two decoded tree blocks: thresholds, leaf values, 16-bit slots."""
    entries = tree_block * (I + 1)
    return 2 * (2 * _r4(entries + 3) + _r4(entries // 2 + 3))


def _smem_words(stage, rows, tree_block, I, C, n_fu, extra) -> int:
    """The words of csrc/packed_walk.cuh::make_layout: keep the two in step."""
    w = 0
    if stage & STAGE_X:
        w += _r4((n_fu + 1) * rows)
    if stage & STAGE_TREES:
        w += _tree_words(tree_block, I)
    return w + _r4(tree_block * rows) + _r4(rows * C) + _r4(extra)


def decoded_bytes(T: int, I: int) -> int:
    """The decoded model the kernels walk (csrc/packed_walk.cuh): a
    threshold, a leaf value and a 16-bit feature slot for each of the
    T * (I + 1) entries."""
    return 10 * T * (I + 1)


@functools.lru_cache(maxsize=1024)
def launch_plan(n: int, T: int, I: int, C: int, n_fu: int,
                early_exit: bool = False) -> PredictPlan:
    """The plan for ``n`` rows through ``T`` trees of ``I`` nodes, ``C``
    classes and ``n_fu`` used features (the source's notes say why).

    Rows: 128 a block where such tiles alone give ``TARGET_BLOCKS``, else
    32; fewer while the tile's used x exceeds ``X_TILE_BYTES`` (past 32
    rows, x is read from global memory).  B1 (``early_exit=False``) splits
    the tree blocks over the grid while the tiles give fewer than
    ``TARGET_BLOCKS``; B3 never does (an exit depends on the whole prefix),
    and stages its exit tables.  Two decoded tree blocks are staged under
    ``TREE_BYTES``, else read from global memory.  Past ``SMEM_MAX`` the
    trees, then x, go to global memory.
    """
    tree_block = tree_block_for(C)
    n_tblocks = -(-T // tree_block)
    rows = 128 if -(-n // 128) >= TARGET_BLOCKS else 32
    fit = rows
    while fit > 32 and 4 * fit * (n_fu + 1) > X_TILE_BYTES:
        fit //= 2
    stage = 0
    if 4 * fit * (n_fu + 1) <= X_TILE_BYTES:
        rows, stage = fit, STAGE_X
    tiles = -(-n // rows)
    groups, per_group = 1, n_tblocks
    if not early_exit and n_tblocks > 1 and tiles < TARGET_BLOCKS:
        want = min(n_tblocks, -(-TARGET_BLOCKS // tiles))
        per_group = n_tblocks // want  # so that groups >= want
        groups = -(-n_tblocks // per_group)
    # a staged block copies 16-bit slots in 4-byte words: rows of even length
    if I > 0 and 4 * _tree_words(tree_block, I) <= TREE_BYTES:
        stage |= STAGE_TREES
    # B3: the live-row lists, the warps' counts, rem_blocks and slack
    extra = 2 * rows + _WARPS + n_tblocks * C + C if early_exit else 0
    words = lambda st: _smem_words(st, rows, tree_block, I, C, n_fu, extra)
    for bit in (STAGE_TREES, STAGE_X):
        if 4 * words(stage) <= SMEM_MAX:
            break
        stage &= ~bit
    if 4 * words(stage) > SMEM_MAX:
        raise ValueError(f"packed inference: {C} classes of {T} trees need more than "
                         f"{SMEM_MAX} B of shared memory for a block's sums")
    return PredictPlan(rows, groups, per_group, stage, 4 * words(stage), (tiles, groups))


def _entry(name: str, symbol: str, n_ptr: int, n_int: int, n_float: int = 0):
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_packed(who, x, words, leaf_ref, leaf_values, thr_table, thr_offsets,
                  used_features, base_score, *, max_depth, tidx_bits, n_ensembles,
                  max_feature):
    """Refuse what the kernels do not take; returns ``(n, d, T, I, C, n_fu)``."""
    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"{who}: {msg}")

    tensors = {
        "x": (x, torch.float32),
        "words": (words, torch.int32),
        "leaf_ref": (leaf_ref, torch.int32),
        "leaf_values": (leaf_values, torch.float32),
        "thr_table": (thr_table, torch.float32),
        "thr_offsets": (thr_offsets, torch.int32),
        "used_features": (used_features, torch.int32),
        "base_score": (base_score, torch.float32),
    }
    for name, (t, dtype) in tensors.items():
        check(isinstance(t, torch.Tensor), f"{name} must be a torch.Tensor")
        check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        check(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        check(t.is_contiguous(), f"{name} must be contiguous")
    C = int(n_ensembles)
    check(C >= 1, f"n_ensembles must be >= 1, got {C}")
    check(x.dim() == 2, f"x must be (n, d), got shape {tuple(x.shape)}")
    for name in ("leaf_values", "thr_table", "thr_offsets", "used_features"):
        check(tensors[name][0].dim() == 1, f"{name} must be 1-D")
    n, d = x.shape
    check(words.dim() == 2, "words must be (T, I)")
    T, I = words.shape
    n_fu = used_features.shape[0]
    check(I == 2**max_depth - 1, f"words has {I} nodes, depth {max_depth} needs {2**max_depth - 1}")
    check(tuple(leaf_ref.shape) == (T, I + 1), f"leaf_ref must be ({T}, {I + 1})")
    check(tuple(base_score.shape) == (C,), f"base_score must be ({C},)")
    check(tuple(thr_offsets.shape) == (n_fu + 1,), f"thr_offsets must be ({n_fu + 1},)")
    check(0 <= tidx_bits < 32, f"tidx_bits {tidx_bits} out of range")
    check(T == 0 or leaf_values.numel() >= 1, "leaf_values is empty")
    check(n_fu == 0 or thr_table.numel() >= 1, "thr_table is empty")
    check(n_fu <= MAX_USED_FEATURES,
          f"{n_fu} used features, the kernels take at most {MAX_USED_FEATURES}")
    if n_fu:
        if max_feature is None:
            lo, max_feature = (int(v) for v in torch.aminmax(used_features))
            check(lo >= 0, f"used_features holds the negative index {lo}")
        check(max_feature < d, f"x has {d} features, the model reads feature {max_feature}")
    check(x.device.type in ("cpu", "cuda"), f"unsupported device {x.device}")
    return n, d, T, I, C, n_fu


def packed_predict(
    x,
    words,
    leaf_ref,
    leaf_values,
    thr_table,
    thr_offsets,
    used_features,
    base_score,
    *,
    max_depth: int,
    tidx_bits: int,
    n_ensembles: int,
    max_feature: int | None = None,
) -> torch.Tensor:
    """(n, d) raw floats -> (n, C) ensemble scores from the packed model.

    Spans (``repro_torch.tracing``): ``predict.check`` for the checks of the
    arguments, ``predict.launch`` for the rest (on the card the buffers, the
    plan and the launch; on CPU rows the plain version)."""
    with tracing.span("predict.check"):
        n, d, T, I, C, n_fu = _check_packed(
            "packed_predict", x, words, leaf_ref, leaf_values, thr_table, thr_offsets,
            used_features, base_score, max_depth=max_depth, tidx_bits=tidx_bits,
            n_ensembles=n_ensembles, max_feature=max_feature)
    with tracing.span("predict.launch", rows=n):
        if T == 0 or n == 0:  # zero-tree artifact (or no rows): the base scores
            return base_score[None, :].expand(n, C).clone()
        if x.device.type == "cpu":
            return packed_predict_ref(
                x, words, leaf_ref, leaf_values, thr_table, thr_offsets,
                used_features, base_score, max_depth=max_depth,
                tidx_bits=tidx_bits, n_ensembles=C,
            )
        plan = launch_plan(n, T, I, C, n_fu)
        out = torch.empty((n, C), dtype=torch.float32, device=x.device)
        # the split grid's per-tree-block partials, summed in order by a last launch
        scratch = (torch.empty((-(-T // tree_block_for(C)), n, C), dtype=torch.float32,
                               device=x.device) if plan.split else None)
        decoded = torch.empty(decoded_bytes(T, I), dtype=torch.uint8, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _entry("packed_predict", "toad_packed_predict", 11, 15)(
                x.data_ptr(), words.data_ptr(), leaf_ref.data_ptr(),
                leaf_values.data_ptr(), thr_table.data_ptr(), thr_offsets.data_ptr(),
                used_features.data_ptr(), base_score.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), decoded.data_ptr(),
                n, d, T, I, C, n_fu, thr_table.shape[0], leaf_values.shape[0],
                max_depth, tidx_bits, tree_block_for(C), plan.rows, plan.groups,
                plan.per_group, plan.stage, stream,
            )
        if err != 0:
            raise RuntimeError(f"packed_predict: kernel launch failed (cudaError {err})")
        with _launch_lock:
            packed_predict.launches += 1
        return out


#: kernel launches since the count was last set to 0
packed_predict.launches = 0


def _round_up_f32(x64: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounding toward +inf (keeps bounds sound)."""
    x32 = x64.astype(np.float32)
    low = x32.astype(np.float64) < x64
    return np.where(low, np.nextafter(x32, np.float32(np.inf)), x32)


def exit_tables(bound, slack, *, n_trees: int, n_ensembles: int,
                min_trees: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's float32 exit tables from the (T+1, C) float64 bound.

    Returns ``(rem_blocks, slack32)``: the bound row at each block boundary
    ``min((b+1)·tree_block, T)``, rounded *up* when narrowed to float32 so
    narrowing can only make exits later, with the rows below ``min_trees``
    forced to +inf (no exit there); and the (C,) slack, rounded up too.
    """
    T, C = int(n_trees), int(n_ensembles)
    tree_block = tree_block_for(C)
    n_tblocks = -(-T // tree_block)
    bound64 = np.asarray(bound, np.float64)
    if bound64.shape != (T + 1, C):
        raise ValueError(f"bound table shape {bound64.shape} != {(T + 1, C)}")
    slack64 = np.asarray(slack, np.float64)
    if slack64.shape != (C,):
        raise ValueError(f"slack shape {slack64.shape} != {(C,)}")
    boundaries = np.minimum((np.arange(n_tblocks) + 1) * tree_block, T)
    rem_blocks = _round_up_f32(bound64[boundaries])
    rem_blocks[boundaries < int(min_trees)] = np.inf
    return rem_blocks.astype(np.float32), _round_up_f32(slack64).astype(np.float32)


def device_exit_tables(bound, slack, *, n_trees: int, n_ensembles: int,
                       min_trees: int = 0, device="cpu"):
    """:func:`exit_tables` as float32 tensors on ``device``.

    Serving makes them once per model and policy and passes them to every
    batch as ``tables=``, so no batch rebuilds or copies them.
    """
    rem_np, slack_np = exit_tables(bound, slack, n_trees=n_trees,
                                   n_ensembles=n_ensembles, min_trees=min_trees)
    return (torch.from_numpy(rem_np).to(device, non_blocking=True),
            torch.from_numpy(slack_np).to(device, non_blocking=True))


def packed_predict_early_exit(
    x,
    words,
    leaf_ref,
    leaf_values,
    thr_table,
    thr_offsets,
    used_features,
    base_score,
    bound=None,
    slack=None,
    *,
    max_depth: int,
    tidx_bits: int,
    n_ensembles: int,
    guard: float = 0.0,
    min_trees: int = 0,
    max_feature: int | None = None,
    tables=None,
):
    """Early-exit packed inference: ``(scores, trees_evaluated, exited)``.

    ``bound`` is the (T+1, C) float64 ``remaining_mass`` table for the
    packed tree order and ``slack`` the (C,) policy slack, both on the host
    (:func:`exit_tables` narrows them; they reach the device without a
    sync).  ``tables``, the pair :func:`device_exit_tables` makes on x's
    device, takes the place of ``bound``, ``slack`` and ``min_trees``.
    ``trees_evaluated`` (n,) int32 is the per-row decision-final
    prefix, block-aligned, and ``exited`` (n,) bool is where it stopped
    before T; all three lie on x's device.  An exited row's scores are its
    sums at its exit boundary (the Pallas kernel may add more blocks to
    them while their tile lives): its label is the full ensemble's, its
    scores are partial.  T == 0 returns the base scores, zeros and all
    False without a launch.
    """
    n, d, T, I, C, n_fu = _check_packed(
        "packed_predict_early_exit", x, words, leaf_ref, leaf_values, thr_table,
        thr_offsets, used_features, base_score, max_depth=max_depth,
        tidx_bits=tidx_bits, n_ensembles=n_ensembles, max_feature=max_feature)
    tree_block = tree_block_for(C)
    if tables is None:
        # a pageable host buffer, copied without blocking: staged before
        # the call returns, and no wait for the stream
        tables = device_exit_tables(bound, slack, n_trees=T, n_ensembles=C,
                                    min_trees=min_trees, device=x.device)
    elif bound is not None or slack is not None or min_trees:
        raise ValueError("packed_predict_early_exit: pass tables, or bound, slack "
                         "and min_trees, not both")
    rem_blocks, slack32 = tables
    for name, t, shape in (("rem_blocks", rem_blocks, (-(-T // tree_block), C)),
                           ("slack", slack32, (C,))):
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                and t.device == x.device and t.is_contiguous()
                and tuple(t.shape) == shape):
            raise ValueError(f"packed_predict_early_exit: tables' {name} must be a "
                             f"contiguous float32 {shape} tensor on {x.device}")
    if T == 0 or n == 0:
        return (base_score[None, :].expand(n, C).clone(),
                torch.zeros((n,), dtype=torch.int32, device=x.device),
                torch.zeros((n,), dtype=torch.bool, device=x.device))
    # guard travels as float32, as the plain version's float32 arithmetic
    # and the kernel's c_float take it
    guard32 = float(np.float32(guard))
    if x.device.type == "cpu":
        scores, exit_at = packed_predict_early_exit_ref(
            x, words, leaf_ref, leaf_values, thr_table, thr_offsets,
            used_features, base_score, rem_blocks, slack32, max_depth=max_depth,
            tidx_bits=tidx_bits, n_ensembles=C, tree_block=tree_block,
            guard=guard32,
        )
    else:
        plan = launch_plan(n, T, I, C, n_fu, early_exit=True)
        scores = torch.empty((n, C), dtype=torch.float32, device=x.device)
        exit_at = torch.empty((n,), dtype=torch.int32, device=x.device)
        decoded = torch.empty(decoded_bytes(T, I), dtype=torch.uint8, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _entry("packed_predict_ee", "toad_packed_predict_ee", 13, 13, 1)(
                x.data_ptr(), words.data_ptr(), leaf_ref.data_ptr(),
                leaf_values.data_ptr(), thr_table.data_ptr(), thr_offsets.data_ptr(),
                used_features.data_ptr(), base_score.data_ptr(), rem_blocks.data_ptr(),
                slack32.data_ptr(), scores.data_ptr(), exit_at.data_ptr(), decoded.data_ptr(),
                n, d, T, I, C, n_fu, thr_table.shape[0], leaf_values.shape[0],
                max_depth, tidx_bits, tree_block, plan.rows, plan.stage, guard32, stream,
            )
        if err != 0:
            raise RuntimeError(
                f"packed_predict_early_exit: kernel launch failed (cudaError {err})")
        with _launch_lock:
            packed_predict_early_exit.launches += 1
    # a decision at the final boundary saved nothing: not an exit
    return scores, exit_at.clamp(max=T), exit_at < T


#: kernel launches since the count was last set to 0
packed_predict_early_exit.launches = 0
