"""Quantile binning of raw features: the wrapper around the CUDA kernel.

``binning`` keeps the signature of the JAX package's
``repro.kernels.binning.binning`` (which runs the Pallas TPU kernel
``_kernel``).  A CUDA tensor launches the hand-written kernel in
``csrc/binning.cu`` (built for ``sm_90a`` at first use) or raises; a CPU
tensor runs the plain version, ``kernels.ref.binning_ref``.  There is no
fallback from one to the other.

Contract: ``x`` (n, d) and ``edges`` (d, E), both cast to float32 as the
JAX package casts them, on one device, contiguous after the cast; every
edge row sorted (non-decreasing, +inf padding at its tail), as
``gbdt.binning.fit_bins`` makes them and toadcheck (TOAD107) checks them
in a bundle.  The result is ``bin = #{e < x}`` per feature, int32, with an
+inf edge never counted and NaN in bin ``E``, as ``apply_bins`` places it.
The kernel finds the count by a binary search, which equals it only on a
sorted row; it does not check the order (a row out of order is outside
the contract, and the plain version, which counts, would differ there).
E = 0 returns zeros, and an empty ``x`` an empty result, without a launch.

:func:`launch_plan` chooses how the kernel takes a call (the source's note
says why): 4-feature vector loads when ``d % 4 == 0`` and ``x`` is 16-byte
aligned, scalar loads otherwise; the features a block stages; the search's
step count; staged edge rows or, past the staging cap, rows read from
global memory.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import binning_ref

_launch_lock = threading.Lock()
#: rows a block bins; bytes of staged edge rows a block may hold
ROWS_PER_BLOCK = 4096
MAX_STAGE_BYTES = 48 * 1024
MAX_FEATURES = 32


class BinningPlan(NamedTuple):
    """How the kernel takes one call: ``vec`` features a load (4 or 1),
    ``features`` a block (a power of two), ``steps`` of the search (2^steps
    >= E + 1), ``staged`` edge rows or global-memory ones, ``rows`` a
    block, and the ``grid`` (row tiles, feature chunks)."""

    vec: int
    features: int
    steps: int
    staged: bool
    rows: int
    grid: tuple[int, int]

    @property
    def stage_bytes(self) -> int:
        return 4 * self.features * (2**self.steps + 1) if self.staged else 0


def launch_plan(n: int, d: int, E: int, aligned: bool) -> BinningPlan:
    """The plan for ``n`` rows of ``d`` features and ``E`` edges a feature;
    ``aligned``: ``x``'s data lies on a 16-byte boundary."""
    vec = 4 if aligned and d % 4 == 0 else 1
    steps = max(1, int(E).bit_length())  # the least k with 2^k >= E + 1
    row_words = 2**steps + 1  # a staged row: 2^k tree nodes at an odd stride
    staged = 4 * 4 * row_words <= MAX_STAGE_BYTES  # four features at least
    features = min(MAX_FEATURES, 1 << max(d - 1, 0).bit_length())
    while staged and 4 * features * row_words > MAX_STAGE_BYTES:
        features //= 2
    return BinningPlan(vec, features, steps, staged, ROWS_PER_BLOCK,
                       (-(-n // ROWS_PER_BLOCK), -(-d // features)))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"binning: {msg}")


def _entry():
    fn = _build.load("binning").toad_binning
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def binning(x, edges) -> torch.Tensor:
    """(n, d) floats × (d, E) sorted edges -> (n, d) int32 bin ids."""
    for name, t in (("x", x), ("edges", edges)):
        _check(isinstance(t, torch.Tensor), f"{name} must be a torch.Tensor")
        _check(t.dim() == 2, f"{name} must be 2-D, got shape {tuple(t.shape)}")
    _check(edges.device == x.device, f"edges is on {edges.device}, x on {x.device}")
    _check(x.device.type in ("cpu", "cuda"), f"unsupported device {x.device}")
    n, d = x.shape
    _check(edges.shape[0] == d, f"x has {d} features, edges has {edges.shape[0]} rows")
    E = edges.shape[1]
    _check(E < 2**31 - 1 and d < 2**31, f"edges of shape {tuple(edges.shape)} too large")
    x = x.to(torch.float32)
    edges = edges.to(torch.float32)
    _check(x.is_contiguous() and edges.is_contiguous(), "x and edges must be contiguous")
    if E == 0 or n == 0 or d == 0:
        return torch.zeros((n, d), dtype=torch.int32, device=x.device)
    if x.device.type == "cpu":
        return binning_ref(x, edges)
    plan = launch_plan(n, d, E, x.data_ptr() % 16 == 0)
    _check(plan.grid[1] <= 65535, f"{d} features need more than 65,535 feature chunks")
    out = torch.empty((n, d), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(x.data_ptr(), edges.data_ptr(), out.data_ptr(), n, d, E,
                       plan.vec, plan.features, plan.steps, int(plan.staged),
                       plan.rows, stream)
    if err != 0:
        raise RuntimeError(f"binning: kernel launch failed (cudaError {err})")
    with _launch_lock:
        binning.launches += 1
    return out


#: kernel launches since the count was last set to 0
binning.launches = 0
