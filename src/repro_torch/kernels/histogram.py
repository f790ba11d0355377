"""Training histograms: the wrapper around the CUDA kernel, and a matmul path.

``histogram`` keeps the signature of the JAX package's
``repro.kernels.histogram.histogram`` (which runs the Pallas TPU kernel
``_kernel``).  A CUDA tensor launches the hand-written kernel in
``csrc/histogram.cu`` (built for ``sm_90a`` at first use) or raises; a CPU
tensor runs the plain version, ``kernels.ref.histogram_ref``.  There is no
fallback from one to the other.  The kernel accumulates in int64 fixed
point, so its sums are the same bits on every run (the source's note says
how); the plain version adds in row order.

The inputs are checked the same way on both devices: bins (n, d) uint8
(n_bins <= 256) or int32, in any layout (the kernel reads element (r, f)
at the tensor's own strides; the trainer keeps them row-major, so a
thread reads a row's 32-feature slice as one 32-byte sector); gh (n, CH)
float, cast to contiguous float32, 1 <= CH <= 8; pos (n,) int32.  Rows with ``pos``
outside ``[0, n_nodes)`` contribute nothing, and on the card they are not
read: the kernel sorts the kept rows by node first.

:func:`launch_plan` chooses how the kernel takes a call (the source's note
says why): the features a block keeps in shared memory, the rows of a
tile and the tile slots of the grid.

``histogram_fused`` is not a kernel: per feature, a bin one-hot (n_bins, n)
multiplied by the node-expanded channel matrix (n, n_nodes * CH) with
``torch.matmul`` in fp32, as the JAX package computes it outside Pallas.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import histogram_ref

MAX_CHANNELS = 8
_SMEM_MAX = 232448  # bytes of shared memory one block may use on sm_90
_launch_lock = threading.Lock()
#: features a block takes at most (a lane each)
MAX_FEATURES = 32
#: shared memory a block's cells may take (256 bins x 3 channels x 32 features)
SMEM_BUDGET = 200 * 1024
#: blocks a call aims at (four an SM, one resident at a time), and a tile's
#: least rows
TARGET_BLOCKS = 132 * 4
MIN_TILE_ROWS = 2048
#: the grid's most tile slots (gridDim.y); a block walks further tiles in turn
MAX_TILE_SLOTS = 65535
#: the kernels one call launches (csrc/histogram.cu), by name: a profile of
#: the card sums the histogram's device time over these
HISTOGRAM_KERNELS = ("hist_count_kernel", "hist_plan_kernel", "hist_scatter_kernel",
                     "histogram_kernel", "hist_one_bin_kernel", "to_float_kernel")


class HistogramPlan(NamedTuple):
    """How the kernel takes one call: ``features`` a block (a power of two,
    a lane each), ``tile_rows`` (rows of one node a block adds at a time)
    and the ``grid`` (feature groups, tile slots)."""

    features: int
    tile_rows: int
    grid: tuple[int, int]


def launch_plan(n: int, d: int, n_nodes: int, n_bins: int, CH: int) -> HistogramPlan:
    """The plan for ``n`` rows of ``d`` features into ``n_nodes`` x
    ``n_bins`` x ``CH`` cells.

    Features: ``d`` rounded up to a power of two, at most 32, halved while
    the cells (8 bytes each) exceed ``SMEM_BUDGET``; one in a one-bin call,
    which needs no shared cells.  Tiles: a node's kept rows in runs of
    ``tile_rows``, so that the blocks with work number about
    ``TARGET_BLOCKS`` whatever the split of rows between nodes; there are at
    most ``ceil(n / tile_rows) + n_nodes`` of them."""
    features = 1
    if n_bins > 1:
        features = min(MAX_FEATURES, 1 << max(d - 1, 0).bit_length())
        while features > 1 and 8 * n_bins * CH * features > SMEM_BUDGET:
            features //= 2
    groups = -(-d // features)
    tile_rows = max(MIN_TILE_ROWS, -(-n * groups // TARGET_BLOCKS))
    slots = min(-(-n // tile_rows) + n_nodes, MAX_TILE_SLOTS)
    return HistogramPlan(features, tile_rows, (groups, slots))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"histogram: {msg}")


def _entry():
    fn = _build.load("histogram").toad_histogram
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_longlong] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def histogram(bins, gh, pos, *, n_nodes: int, n_bins: int) -> torch.Tensor:
    """(n, d) bins × (n, CH) channels × (n,) node ids -> (n_nodes, d, n_bins, CH)
    float32 sums."""
    for name, t in (("bins", bins), ("gh", gh), ("pos", pos)):
        _check(isinstance(t, torch.Tensor), f"{name} must be a torch.Tensor")
        _check(t.device == bins.device, f"{name} is on {t.device}, bins on {bins.device}")
    _check(bins.dim() == 2, f"bins must be (n, d), got shape {tuple(bins.shape)}")
    n, d = bins.shape
    _check(bins.dtype in (torch.uint8, torch.int32),
           f"bins must be uint8 or int32, got {bins.dtype}")
    _check(gh.dim() == 2 and gh.shape[0] == n, f"gh must be ({n}, CH)")
    _check(gh.is_floating_point(), f"gh must be floating point, got {gh.dtype}")
    _check(pos.shape == (n,) and pos.dtype == torch.int32, f"pos must be ({n},) int32")
    CH = gh.shape[1]
    _check(1 <= CH <= MAX_CHANNELS, f"CH must be in 1..{MAX_CHANNELS}, got {CH}")
    _check(n_nodes >= 1 and n_bins >= 1, "n_nodes and n_bins must be >= 1")
    _check(n_bins * CH * 8 <= _SMEM_MAX,
           f"one node's cells ({n_bins} bins x {CH} channels) exceed shared memory")
    gh = gh.to(torch.float32).contiguous()
    pos = pos.contiguous()
    if n == 0 or d == 0:
        return torch.zeros((n_nodes, d, n_bins, CH), dtype=torch.float32, device=gh.device)
    if bins.device.type == "cpu":
        return histogram_ref(bins, gh, pos, n_nodes, n_bins)
    _check(bins.device.type == "cuda", f"unsupported device {bins.device}")
    _check(n <= 2**30, f"{n} rows exceed the kernel's int32 row ids")
    plan = launch_plan(n, d, n_nodes, n_bins, CH)
    # scratch (and gh's float32 copy) may be freed on return while the kernels
    # are still queued: the caching allocator hands it out again only to work
    # on this stream, which runs after them
    dev = bins.device
    shape = (n_nodes, d, n_bins, CH)
    ints = torch.zeros((CH + 4 * n_nodes + 2,), dtype=torch.int32, device=dev)
    sorted_rows = n if n_bins > 1 else 0  # a one-bin call needs no sort
    rowid = torch.empty((sorted_rows,), dtype=torch.int32, device=dev)
    sgh = torch.empty((sorted_rows, CH), dtype=torch.float32, device=dev)
    acc = torch.zeros(shape, dtype=torch.int64, device=dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(
            bins.data_ptr(), int(bins.dtype == torch.uint8), *bins.stride(),
            gh.data_ptr(), pos.data_ptr(), ints.data_ptr(), rowid.data_ptr(),
            sgh.data_ptr(), acc.data_ptr(), out.data_ptr(), n, d, CH, n_nodes, n_bins,
            plan.features, plan.tile_rows, plan.grid[1], stream,
        )
    if err != 0:
        raise RuntimeError(f"histogram: kernel launch failed (cudaError {err})")
    with _launch_lock:
        histogram.launches += 1
    return out


#: kernel launches since the count was last set to 0
histogram.launches = 0


def histogram_fused(bins, gh, pos, *, n_nodes: int, n_bins: int) -> torch.Tensor:
    """(n, d) bins × (n, CH) channels × (n,) node ids -> (n_nodes, d, n_bins, CH).

    Per feature, a bin one-hot contracted with the node-expanded channel
    matrix by ``torch.matmul`` in fp32 — no ``(n·d, CH)`` scratch array and
    no scatter.  On the card TF32 is turned off for it
    (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default):
    TF32 keeps ~3 decimal digits and would break the 1e-5 contract.  ``pos``
    outside ``[0, n_nodes)`` matches no column and contributes nothing.
    """
    n, d = bins.shape
    CH = gh.shape[1]
    if bins.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    gh = gh.to(torch.float32)
    # A[s, node*CH + c] = gh[s, c] * [pos[s] == node] — shared by all features
    nodes = torch.arange(n_nodes, device=gh.device, dtype=torch.int64)
    node_oh = pos.to(torch.int64)[:, None] == nodes[None, :]
    A = (node_oh[:, :, None] * gh[:, None, :]).reshape(n, n_nodes * CH)
    iota_b = torch.arange(n_bins, device=gh.device, dtype=torch.int64)[:, None]
    out = torch.stack([
        torch.matmul((iota_b == bins[:, f].to(torch.int64)[None, :]).to(torch.float32), A)
        for f in range(d)
    ])  # (d, n_bins, n_nodes*CH)
    return out.reshape(d, n_bins, n_nodes, CH).permute(2, 0, 1, 3).contiguous()
