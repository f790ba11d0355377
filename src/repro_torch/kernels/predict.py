"""Packed ToaD inference: the wrapper around the CUDA kernel.

``packed_predict`` keeps the signature of the JAX package's
``repro.kernels.predict.packed_predict`` (which runs the Pallas TPU kernel
``_kernel``).  A CUDA tensor launches the hand-written kernel in
``csrc/packed_predict.cu`` (built for ``sm_90a`` at first use) or raises; a
CPU tensor runs the plain version, ``kernels.ref.packed_predict_ref``.
There is no fallback from one to the other.

The inputs are checked the same way on both devices, so the CPU tests check
what the kernel takes: x (n, d) contiguous float32; words (T, I) int32
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

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import packed_predict_ref

_launch_lock = threading.Lock()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"packed_predict: {msg}")


def _entry():
    fn = _build.load("packed_predict").toad_packed_predict
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
        _check(isinstance(t, torch.Tensor), f"{name} must be a torch.Tensor")
        _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _check(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    C = int(n_ensembles)
    _check(C >= 1, f"n_ensembles must be >= 1, got {C}")
    _check(x.dim() == 2, f"x must be (n, d), got shape {tuple(x.shape)}")
    for name in ("leaf_values", "thr_table", "thr_offsets", "used_features"):
        _check(tensors[name][0].dim() == 1, f"{name} must be 1-D")
    n, d = x.shape
    _check(words.dim() == 2, "words must be (T, I)")
    T, I = words.shape
    n_fu = used_features.shape[0]
    _check(I == 2**max_depth - 1, f"words has {I} nodes, depth {max_depth} needs {2**max_depth - 1}")
    _check(tuple(leaf_ref.shape) == (T, I + 1), f"leaf_ref must be ({T}, {I + 1})")
    _check(tuple(base_score.shape) == (C,), f"base_score must be ({C},)")
    _check(tuple(thr_offsets.shape) == (n_fu + 1,), f"thr_offsets must be ({n_fu + 1},)")
    _check(0 <= tidx_bits < 32, f"tidx_bits {tidx_bits} out of range")
    _check(T == 0 or leaf_values.numel() >= 1, "leaf_values is empty")
    _check(n_fu == 0 or thr_table.numel() >= 1, "thr_table is empty")
    if n_fu:
        if max_feature is None:
            lo, max_feature = (int(v) for v in torch.aminmax(used_features))
            _check(lo >= 0, f"used_features holds the negative index {lo}")
        _check(max_feature < d,
               f"x has {d} features, the model reads feature {max_feature}")
    if T == 0 or n == 0:  # zero-tree artifact (or no rows): the base scores
        return base_score[None, :].expand(n, C).clone()
    if x.device.type == "cpu":
        return packed_predict_ref(
            x, words, leaf_ref, leaf_values, thr_table, thr_offsets,
            used_features, base_score, max_depth=max_depth,
            tidx_bits=tidx_bits, n_ensembles=C,
        )
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    out = torch.empty((n, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(
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
