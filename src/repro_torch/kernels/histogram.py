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
at the tensor's own strides; the trainer keeps them column-major,
``bins_t.t()`` of a contiguous (d, n) tensor, so the kernel reads each
feature's column in order); gh (n, CH) float, cast to contiguous float32,
1 <= CH <= 8; pos (n,) int32.  Rows with ``pos`` outside
``[0, n_nodes)`` contribute nothing.

``histogram_fused`` is not a kernel: per feature, a bin one-hot (n_bins, n)
multiplied by the node-expanded channel matrix (n, n_nodes * CH) with
``torch.matmul`` in fp32, as the JAX package computes it outside Pallas.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import histogram_ref

MAX_CHANNELS = 8
_SMEM_MAX = 232448  # bytes of shared memory one block may use on sm_90
_launch_lock = threading.Lock()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"histogram: {msg}")


def _entry():
    fn = _build.load("histogram").toad_histogram
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_longlong] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
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
    # scratch (and gh's float32 copy) may be freed on return while the kernels
    # are still queued: the caching allocator hands it out again only to work
    # on this stream, which runs after them
    shape = (n_nodes, d, n_bins, CH)
    amax_bits = torch.zeros((CH,), dtype=torch.int32, device=bins.device)
    acc = torch.zeros(shape, dtype=torch.int64, device=bins.device)
    out = torch.empty(shape, dtype=torch.float32, device=bins.device)
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        err = _entry()(
            bins.data_ptr(), int(bins.dtype == torch.uint8), *bins.stride(),
            gh.data_ptr(), pos.data_ptr(), amax_bits.data_ptr(), acc.data_ptr(),
            out.data_ptr(), n, d, CH, n_nodes, n_bins, stream,
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
