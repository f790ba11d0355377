"""The trainer's greedy node-by-node split commit of one tree level: the
wrapper around the CUDA kernel, and the plain version.

Within a level, splits commit node by node, so a feature or threshold
paid for by an earlier node is free for every later node (the paper's
greedy semantics).  ``commit_level`` takes a level's gains and validity
masks and updates the used sets and the tree's arrays in place.

A CUDA tensor launches the hand-written kernel in ``csrc/commit.cu``
(built for ``sm_90a`` at first use; one launch a level) or raises; a CPU
tensor runs the plain version, :func:`commit_level_ref`, the loop the
trainer ran before the kernel.  A tensor on the meta device (the dry
run's trace, which has no values to launch on) runs the plain version
too.  There is no fallback from one to the other.  The kernel replaces
no Pallas kernel (the JAX package commits in a ``fori_loop`` over nodes);
the source's note says what bounds it and how its design meets that.  The
kernel equals the plain version on the card to the bit: there PyTorch
divides a tensor by the Python number ``n_rows`` as a product with its
float32 reciprocal, and the kernel does the same (the CPU divides).

The inputs are checked the same way on every device: ``gain`` (n_nodes,
d, E) float32 and ``valid`` of that shape bool; ``totC`` and ``dead``
(n_nodes,) float32 and bool; ``pen_f``, ``pen_t`` 0-d float32 (passed to
the kernel by pointer, never read back); ``used_feat`` (d,) and
``used_thr`` (d, E) bool, ``t_feat``, ``t_thr`` (I,) int32, ``t_split``
(I,) bool, ``t_gain`` (I,) float32 and ``n_splits`` 0-d int32, which are
updated in place; every tensor contiguous, on ``gain``'s device.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

_launch_lock = threading.Lock()


def _at(t: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` for 0-d index tensors, as a (1,) tensor (no read-back)."""
    return t[tuple(i.reshape(1) for i in idx)]


def _set(t: torch.Tensor, value: torch.Tensor, *idx: torch.Tensor) -> None:
    """``t[idx] = value`` in place for 0-d index tensors (no read-back)."""
    t.index_put_(tuple(i.reshape(1) for i in idx), value.reshape(1).to(t.dtype))


def commit_level_ref(gain, valid, totC, dead, pen_f, pen_t, *, cegb: float, n_rows: int,
                     base_idx: int, used_feat, used_thr, t_feat, t_thr, t_split, t_gain,
                     n_splits) -> None:
    """The plain version: the level's nodes in order, each a few tensor
    operations, indexing with 0-d tensors (nothing is read back)."""
    n_nodes, _, E = gain.shape
    for j in range(n_nodes):
        pen = pen_f * (~used_feat[:, None]) + pen_t * (~used_thr)
        # CEGB (Peter et al. 2017): per-split evaluation cost scaled by
        # the fraction of samples that must traverse this node
        split_cost = cegb * totC[j] / n_rows
        eff = torch.where(valid[j], gain[j] - pen - split_cost, -torch.inf)
        best, flat = eff.reshape(-1).max(0)  # first maximal index, as argmax
        f = torch.div(flat, E, rounding_mode="floor")
        e = flat % E
        ok = (best > 0.0) & ~dead[j]
        node = base_idx + j
        t_feat[node] = torch.where(ok, f.to(torch.int32), t_feat[node])
        t_thr[node] = torch.where(ok, e.to(torch.int32), t_thr[node])
        t_split[node] = ok | t_split[node]
        t_gain[node] = torch.where(ok, _at(gain[j].reshape(-1), flat)[0], t_gain[node])
        _set(used_feat, _at(used_feat, f) | ok, f)
        _set(used_thr, _at(used_thr, f, e) | ok, f, e)
        n_splits += ok


def _check(gain, valid, totC, dead, pen_f, pen_t, used_feat, used_thr, t_feat, t_thr, t_split,
           t_gain, n_splits, base_idx: int) -> None:
    """Raise ValueError unless every tensor has its dtype, shape, device
    and layout; the message is built only for a tensor that fails."""
    if not isinstance(gain, torch.Tensor) or gain.dim() != 3:
        raise ValueError("commit_level: gain must be an (n_nodes, d, E) torch.Tensor")
    n_nodes, d, E = gain.shape
    I = t_feat.shape[0] if isinstance(t_feat, torch.Tensor) and t_feat.dim() == 1 else -1
    level, tree = (n_nodes,), (I,)
    specs = dict(
        gain=(gain, (n_nodes, d, E), torch.float32), valid=(valid, (n_nodes, d, E), torch.bool),
        totC=(totC, level, torch.float32), dead=(dead, level, torch.bool),
        pen_f=(pen_f, (), torch.float32), pen_t=(pen_t, (), torch.float32),
        used_feat=(used_feat, (d,), torch.bool), used_thr=(used_thr, (d, E), torch.bool),
        t_feat=(t_feat, tree, torch.int32), t_thr=(t_thr, tree, torch.int32),
        t_split=(t_split, tree, torch.bool), t_gain=(t_gain, tree, torch.float32),
        n_splits=(n_splits, (), torch.int32),
    )
    for name, (t, shape, dtype) in specs.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"commit_level: {name} must be a torch.Tensor")
        if (t.device != gain.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"commit_level: {name} must be a contiguous {dtype} tensor of shape {shape} "
                f"on {gain.device}; got {t.dtype} of shape {tuple(t.shape)} on {t.device}"
                + ("" if t.is_contiguous() else ", not contiguous"))
    if d * E == 0:
        raise ValueError("commit_level: no candidate split (d * E is 0)")
    if base_idx < 0 or base_idx + n_nodes > I:
        raise ValueError(f"commit_level: nodes {base_idx}..{base_idx + n_nodes - 1} lie "
                         f"outside the tree's {I}")


def _entry():
    fn = _build.load("commit").toad_commit_level
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_double, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 7
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def commit_level(gain, valid, totC, dead, pen_f, pen_t, *, cegb: float, n_rows: int,
                 base_idx: int, used_feat, used_thr, t_feat, t_thr, t_split, t_gain,
                 n_splits) -> None:
    """Commit one level's splits, node by node in order, in place.

    Node ``j`` of the level is tree node ``base_idx + j``.  Its candidates'
    penalised gains are ``valid ? (gain - pen) - cegb * totC[j] / n_rows :
    -inf``, with ``pen = pen_f * !used_feat[f] + pen_t * !used_thr[f, e]``
    under the used sets the earlier nodes left; the first maximal one
    (a NaN first, as ``torch.max``) commits if it is above 0 and the node
    is not dead: ``t_feat``, ``t_thr``, ``t_split`` and ``t_gain`` (the raw
    gain) of the node, the used sets, and ``n_splits`` by one."""
    _check(gain, valid, totC, dead, pen_f, pen_t, used_feat, used_thr, t_feat, t_thr, t_split,
           t_gain, n_splits, base_idx)
    outs = dict(used_feat=used_feat, used_thr=used_thr, t_feat=t_feat, t_thr=t_thr,
                t_split=t_split, t_gain=t_gain, n_splits=n_splits)
    dev = gain.device
    if gain.shape[0] == 0:
        return
    if dev.type in ("cpu", "meta"):
        commit_level_ref(gain, valid, totC, dead, pen_f, pen_t, cegb=cegb, n_rows=n_rows,
                         base_idx=base_idx, **outs)
        return
    if dev.type != "cuda":
        raise ValueError(f"commit_level: unsupported device {dev}")
    n_nodes, d, E = gain.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(
            gain.data_ptr(), valid.data_ptr(), totC.data_ptr(), dead.data_ptr(),
            pen_f.data_ptr(), pen_t.data_ptr(), float(cegb), int(n_rows),
            *(t.data_ptr() for t in outs.values()), n_nodes, d, E, base_idx, stream,
        )
    if err != 0:
        raise RuntimeError(f"commit_level: kernel launch failed (cudaError {err})")
    with _launch_lock:
        commit_level.launches += 1


#: kernel launches since the count was last set to 0
commit_level.launches = 0
