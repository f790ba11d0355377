"""Data-parallel ToaD training over ``torch.distributed`` (the port's
counterpart of ``repro.gbdt.distributed``).

Rows are sharded over the ranks of a process group: rank r of k holds the
contiguous block ``[r·n/k, (r+1)·n/k)`` (:func:`shard_rows`), the layout
of JAX's ``P(axis)``.  Every rank builds its histograms with the
histogram kernel (``kernels.ops.build_histogram``), one all-reduce a level
merges them, and each rank then commits the same splits, so the forest,
the history and the used sets are replicated by construction and
``aux["preds"]`` holds the rank's own rows.

Collectives (``gbdt.trainer.train`` with ``axis_name``): two a fit for the
base statistics and the row count, then a tree's levels and its leaf statistics, one each (9
at depth 8).  A quantized reduction (``cfg.hist_quant_bits``, sibling
subtraction off) is two: a one-element MAX for the scale and the integer
sum.  Payload a rank hands to a tree's histogram all-reduces, at d
features and B bins: ``nodes × d × B × 3`` elements, where ``nodes`` is
``2^(D-1)`` under exact float32 sums with sibling subtraction (the root
and each level's left children) and ``2^D - 1`` quantized, at 4 B an
element (float32, or the int32 carrier of 16-bit payloads) or 1 B (int8).

Two entry points:

* :func:`train_data_parallel` is called on every rank with that rank's
  rows, the torch idiom (SPMD), as JAX's function body runs on every shard.
* :func:`spawn_data_parallel` is the counterpart of JAX's one call with a
  mesh: it spawns ``world_size`` ranks, hands each its rows (memory-mapped
  ``.npy`` files in a temporary directory, never pickled rows), trains, and
  returns rank 0's forest and history with every rank's ``preds`` in row
  order.  The ranks meet through a ``FileStore`` in a temporary directory
  (no fixed TCP port).  Backend: ``gloo`` when the ranks share one card or
  run on the CPU (gloo reduces CUDA tensors itself, through host memory),
  ``nccl`` when each rank has a card of its own.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import host, resolve_device
from repro_torch.gbdt.forest import forest_from_numpy, forest_to_numpy
from repro_torch.gbdt.trainer import GBDTConfig, _bin_storage, deprecated_quant_bits, train
from repro_torch.kernels.histogram import histogram


def pad_to_shards(x: np.ndarray, n_shards: int, pad_value=0):
    """Pad rows so the leading dim divides the data axis."""
    n = x.shape[0]
    pad = -n % n_shards
    if pad:
        pad_block = np.full((pad,) + x.shape[1:], pad_value, dtype=x.dtype)
        x = np.concatenate([x, pad_block], axis=0)
    return x


def shard_rows(x, rank: int, world_size: int):
    """Rank ``rank``'s contiguous block of ``x``'s rows, ``[rank·n/k,
    (rank+1)·n/k)`` for ``k = world_size`` (a view where ``x`` allows one)."""
    n = x.shape[0]
    if n % world_size:
        raise ValueError(f"{n} rows do not divide {world_size} ranks (see pad_to_shards)")
    step = n // world_size
    return x[rank * step:(rank + 1) * step]


def train_data_parallel(
    cfg: GBDTConfig,
    bins,
    y,
    edges,
    group=None,
    penalty_feature=None,
    penalty_threshold=None,
    forestsize=None,
    hist_quant_bits: int | None = None,
):
    """Train with rows sharded over ``group`` (the default group when
    ``None``, which must be initialised); called on every rank with that
    rank's ``bins`` and ``y``.

    The returned forest and history are replicated; ``aux['preds']`` holds
    this rank's rows.  Padding rows (see :func:`pad_to_shards`) perturb the
    histograms as in the JAX package.  ``hist_quant_bits`` is a DEPRECATED
    alias for ``GBDTConfig.hist_quant_bits`` (overrides the config when
    passed).
    """
    cfg = deprecated_quant_bits(cfg, hist_quant_bits, "train_data_parallel")
    return train(cfg, bins, y, edges, penalty_feature, penalty_threshold, forestsize,
                 axis_name="data" if group is None else group)


#: seconds a rank may wait in a collective, and ``run_ranks`` for every result
RANK_TIMEOUT_S = 900.0


def run_ranks(fn, world_size: int, *args, device="cuda") -> list:
    """Run ``fn(rank, device, *args)`` on ``world_size`` spawned processes
    joined in one default process group; return their results in rank
    order.

    ``fn`` must be importable by name (a module-level function) and return
    something picklable.  Rank r runs on card ``r % device_count`` when
    ``device`` is a CUDA device (the caller's default: the card; without one
    it raises), else on the CPU.  Rendezvous through a ``FileStore`` in a
    temporary directory.  A rank that fails stops the run: its traceback is
    raised here and the other ranks are terminated.
    """
    dev = resolve_device(device)
    own_cards = dev.type == "cuda" and torch.cuda.device_count() >= world_size
    backend = "nccl" if own_cards else "gloo"
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="toad-ranks-") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world_size, os.path.join(tmp, "store"), backend,
                                   dev.type, fn, args, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            return _collect(results, procs)
        except BaseException:
            for p in procs:  # the others may wait in a collective for the failed one
                p.terminate()
            raise
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect(results, procs) -> list:
    """Drain every rank's result (before the processes are joined)."""
    got: dict[int, object] = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while len(got) < len(procs):
        try:
            rank, ok, value = results.get(timeout=1.0)
        except queue_mod.Empty:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in got]
            if dead:
                raise RuntimeError(f"rank process(es) exited before reporting: {dead}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks did not finish within {RANK_TIMEOUT_S} s")
            continue
        if not ok:
            raise RuntimeError(_failures(results, {rank: value}))
        got[rank] = value
    return [got[r] for r in range(len(procs))]


def _failures(results, failed: dict, wait_s: float = 2.0) -> str:
    """Every rank's traceback that arrives within ``wait_s``: the first
    to fail is often a rank whose collective lost a peer, not the cause."""
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue_mod.Empty:
            break
        if not ok:
            failed[rank] = value
    return "\n".join(f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items()))


def _rank_main(rank, world_size, store_path, backend, device_type, fn, args, results):
    """A spawned rank: join the group, run ``fn``, report its result."""
    try:
        if backend == "gloo":
            # the ranks share this host: gloo's transport on the loopback
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
            device = torch.device("cpu")
        dist.init_process_group(backend, store=dist.FileStore(store_path, world_size),
                                rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            value = fn(rank, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_data_parallel(
    cfg: GBDTConfig,
    bins,
    y,
    edges,
    world_size: int = 4,
    device="cuda",
    penalty_feature=None,
    penalty_threshold=None,
    forestsize=None,
):
    """Train on ``world_size`` spawned ranks with the rows sharded
    contiguously (module docstring).  ``bins`` (n, d) and ``y`` (n,) are
    host arrays or tensors on any device; n must divide ``world_size``.

    Returns ``(forest, history, aux)`` on ``device`` (the card unless
    ``device="cpu"``; without a card it raises): rank 0's forest, history
    and replicated aux, with ``aux["preds"]`` every rank's rows in row order,
    ``aux["rank_histogram_launches"]`` each rank's count of histogram
    kernel launches (0 on the CPU, where the plain version runs) and
    ``aux["rank_train_seconds"]`` each rank's time in ``train`` (the card
    synchronised before and after).
    """
    dev = resolve_device(device)
    shard_rows(bins, 0, world_size)  # refuses rows that do not divide
    with tempfile.TemporaryDirectory(prefix="toad-shards-") as tmp:
        save_shards(tmp, bins, y, edges)
        ranks = run_ranks(_fit_shard, world_size, tmp, cfg, penalty_feature,
                          penalty_threshold, forestsize, device=dev)
    first = ranks[0]
    put = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    forest = forest_from_numpy(first["forest"], first["n_ensembles"], device=dev)
    history = {k: put(v) for k, v in first["history"].items()}
    aux = {k: put(v) for k, v in first["aux"].items()}
    aux["preds"] = torch.cat([put(r["preds"]) for r in ranks])
    aux["rank_histogram_launches"] = [r["launches"] for r in ranks]
    aux["rank_train_seconds"] = [r["seconds"] for r in ranks]
    return forest, history, aux


def save_shards(directory: str, bins, y, edges) -> None:
    """Write ``bins`` (as the trainer stores them: uint8 up to 256 bins),
    ``y`` and ``edges`` to ``.npy`` files in ``directory``, for the ranks
    to memory-map (:func:`load_shard`)."""
    edges = np.asarray(host(edges), np.float32)
    if not isinstance(bins, torch.Tensor):
        bins = torch.from_numpy(np.asarray(bins))
    np.save(os.path.join(directory, "bins.npy"), host(_bin_storage(bins, edges.shape[1] + 1)))
    np.save(os.path.join(directory, "y.npy"), np.asarray(host(y), np.float32))
    np.save(os.path.join(directory, "edges.npy"), edges)


def load_shard(directory: str, rank: int, world_size: int, device):
    """Rank ``rank``'s rows of the arrays :func:`save_shards` wrote, and the
    edges, on ``device``: ``(bins, y, edges)``.  Only the rank's block is
    read from the memory-mapped files."""
    load = lambda name: np.load(os.path.join(directory, f"{name}.npy"), mmap_mode="r")
    on_device = lambda a: torch.from_numpy(np.array(a)).to(device)
    return (on_device(shard_rows(load("bins"), rank, world_size)),
            on_device(shard_rows(load("y"), rank, world_size)),
            on_device(load("edges")))


def _fit_shard(rank, device, tmp, cfg, penalty_feature, penalty_threshold, forestsize):
    """One rank of :func:`spawn_data_parallel`: load its rows, train,
    return host arrays."""
    bins, y, edges = load_shard(tmp, rank, dist.get_world_size(), device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    histogram.launches = 0
    sync()
    t0 = time.perf_counter()
    forest, history, aux = train_data_parallel(
        cfg, bins, y, edges, None, penalty_feature, penalty_threshold, forestsize)
    sync()
    seconds = time.perf_counter() - t0
    return dict(
        forest=forest_to_numpy(forest),
        n_ensembles=forest.n_ensembles,
        history={k: host(v) for k, v in history.items()},
        aux={k: host(v) for k, v in aux.items() if k != "preds"},
        preds=host(aux["preds"]),
        launches=histogram.launches,
        seconds=seconds,
    )
