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
used_features (|F_U|,) int32; every feature index in [0, d).  Checking the
last needs the largest used feature on the host: pass it as
``max_feature`` (``kernels.ops.DevicePacked`` does, having checked it once)
or the wrapper reads it back from the device, one sync per call.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import packed_predict_early_exit_ref, packed_predict_ref

#: trees per early-exit block before rounding up to a multiple of C (the JAX
#: package's ``TREE_BLOCK``): exits happen only at block boundaries
TREE_BLOCK = 8

_launch_lock = threading.Lock()


def tree_block_for(n_ensembles: int) -> int:
    """``TREE_BLOCK`` rounded up to a multiple of C, so a block holds whole
    rounds and tree ``k`` of a block adds to class column ``k % C``."""
    return -(-TREE_BLOCK // n_ensembles) * n_ensembles


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
    """(n, d) raw floats -> (n, C) ensemble scores from the packed model."""
    n, d, T, I, C, n_fu = _check_packed(
        "packed_predict", x, words, leaf_ref, leaf_values, thr_table, thr_offsets,
        used_features, base_score, max_depth=max_depth, tidx_bits=tidx_bits,
        n_ensembles=n_ensembles, max_feature=max_feature)
    if T == 0 or n == 0:  # zero-tree artifact (or no rows): the base scores
        return base_score[None, :].expand(n, C).clone()
    if x.device.type == "cpu":
        return packed_predict_ref(
            x, words, leaf_ref, leaf_values, thr_table, thr_offsets,
            used_features, base_score, max_depth=max_depth,
            tidx_bits=tidx_bits, n_ensembles=C,
        )
    out = torch.empty((n, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry("packed_predict", "toad_packed_predict", 9, 10)(
            x.data_ptr(), words.data_ptr(), leaf_ref.data_ptr(),
            leaf_values.data_ptr(), thr_table.data_ptr(), thr_offsets.data_ptr(),
            used_features.data_ptr(), base_score.data_ptr(), out.data_ptr(),
            n, d, T, I, C, n_fu, thr_table.shape[0], leaf_values.shape[0],
            max_depth, tidx_bits, stream,
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
        scores = torch.empty((n, C), dtype=torch.float32, device=x.device)
        exit_at = torch.empty((n,), dtype=torch.int32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _entry("packed_predict_ee", "toad_packed_predict_ee", 12, 11, 1)(
                x.data_ptr(), words.data_ptr(), leaf_ref.data_ptr(),
                leaf_values.data_ptr(), thr_table.data_ptr(), thr_offsets.data_ptr(),
                used_features.data_ptr(), base_score.data_ptr(), rem_blocks.data_ptr(),
                slack32.data_ptr(), scores.data_ptr(), exit_at.data_ptr(),
                n, d, T, I, C, n_fu, thr_table.shape[0], leaf_values.shape[0],
                max_depth, tidx_bits, tree_block, guard32, stream,
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
