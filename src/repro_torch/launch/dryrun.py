"""The dry run of the port (``repro.launch.dryrun``): what each (arch ×
shape × mesh) cell costs, from a trace of the port's own step at
production shapes on the **meta device**.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --mesh single --out results/qwen3_train_single.json

One cell a process, as in the JAX package, whose dry run lowers and
compiles on 512 placeholder host devices.  This one computes nothing:
tensors on the meta device carry shapes and dtypes and no data, so the
step runs its Python and dispatches its operators without a card, and the
trace counts them.  It is therefore the one entry point of the port that
asks for no card (``--device`` does not exist here): like JAX's
placeholder devices, it must run where the production cluster is not.

The record keeps JAX's keys where the meaning is the same (``status``,
``arch``, ``shape``, ``mesh``, ``n_chips``, ``kind``, ``tokens_per_step``,
``params_total``, ``params_active``, ``memory.argument_size_in_bytes``,
``memory.output_size_in_bytes``, ``wall_seconds``; ``SKIP`` with
``skip_reason``'s reason) and new keys where it differs:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count of rank 0's step.  It counts matrix products (and convolutions,
  attention) only; XLA also counts elementwise work.
* ``bytes_moved_per_device``: the bytes every operator rank 0 dispatches
  reads and writes (each tensor input and output once; a view, a detach
  or an empty allocation moves none), the eager counterpart of XLA's
  "bytes accessed".
* ``collectives_per_device``: bytes by kind (JAX's names: ``all-reduce``,
  ``all-gather``, ``reduce-scatter``; the result's bytes, as
  ``parse_collectives`` counts them) and ``total``.  Every LM cell traces
  the **meshed** step (the family module given a ``RankMesh`` and
  ``input_specs._dp``'s axes; training through
  ``train.loop.make_train_step`` on the mesh) on rank 0 of a fake process
  group of the production mesh's size, on the meta device: per-device
  FLOPs, bytes moved, collectives and ``peak_live_bytes_per_device`` are
  that rank's (the step takes the global batch, which its peak counts
  whole).  rwkv6's and rglru's ``long_500k`` keep their one row whole on
  every data rank (``_dp`` gives ``None``).  The ``toad_gbdt`` cell's
  collectives are its data-parallel all-reduces on a fake group of 256
  (512) ranks.

Per-device argument and output bytes shard each tensor by its sharding
(``models.param_specs``, the optimizers' ``state_specs``, the input
specs) over the production mesh.  The arguments are the step's own: a
training step's float32 masters, optimizer state, step counter and batch;
serving's weights in the port's dtypes (bf16 but each family's
``F32_ENTRIES``; JAX's abstract parameters are float32), batch or cache
and token.  A training step's outputs are what it writes in place
(parameters, state, step) and the loss; serving's are the logits, split
over the batch's axes, and the cache at its sharding.

**The sequential WKV.**  rwkv6 runs its recurrence as a Python loop over
tokens, so a whole trace of 24 layers at 4,096 or 32,768 positions would
not end within the sweep's timeout.  Its FLOPs and bytes moved are affine
in the sequence length S, but its peak is not at probe lengths: it is the
largest of several affine terms, and the term that leads at a few hundred
positions (with a chunk's (B, 64, H, dh, dh) temporaries) gives way at
longer S to a steeper one (in the reduced config, between 1,024 and 1,792
positions), which a line through short lengths misses.  So those cells are traced at
the full S with :data:`PROBE_LAYERS` layers and solved for the depth
(``probe_lm``, meshed where the cell is: the line then also holds each
kind's collective bytes and the calls); a third depth checks the line, to
the integer, or the cell fails.  The recurrence itself is elementwise, which ``FlopCounterMode``
does not count: the record carries JAX's closed form for it under
``uncounted_flops``, beside, not inside, the counted FLOPs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import weakref
from fractions import Fraction
from types import SimpleNamespace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.input_specs import (
    META,
    SHAPES,
    _dp,
    _info,
    batch_specs,
    decode_specs,
    skip_reason,
)
from repro_torch.launch.mesh import RankMesh, make_production_mesh, shard_bytes, shard_shape
from repro_torch.models.base import (
    count_params,
    leaves,
    map_leaves,
    param_shapes,
    param_specs,
    zeros_of,
)
from repro_torch.models.registry import _tensors

PROBE_LAYERS = (2, 3, 4)  # the layer counts rwkv's cells are traced at


# --------------------------------------------------------------------------
# parameter counts
# --------------------------------------------------------------------------


def count_active_params(cfg, shapes_tree) -> int:
    """Active parameters per token (MoE experts scaled by top_k/E)."""
    total = 0
    for name, shape in leaves(shapes_tree):
        n = math.prod(shape)
        if cfg.n_experts and name in ("w_in", "w_gate", "w_out"):
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


# --------------------------------------------------------------------------
# the meter: bytes moved, live storage, collectives
# --------------------------------------------------------------------------

_NO_TRAFFIC = {"detach", "alias", "_unsafe_view", "lift_fresh", "empty", "empty_like",
               "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense"}


def _unique_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses (a broadcast axis,
    stride 0, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


#: the c10d operators the port issues, by JAX's names (``parse_collectives``)
COLLECTIVE_KINDS = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                    "reduce_scatter_": "reduce-scatter"}


class Meter(TorchDispatchMode):
    """Counts, for the operators dispatched while it is active: the bytes
    they read and write, the most bytes of tensor storage alive at once
    (``peak``; the ``live`` tensors given at the start count from the
    start), and the bytes of every ``torch.distributed`` collective by
    operator (``collectives``: its results, the first argument of each
    c10d operator, in place for an all-reduce, the outputs of a gather),
    with a ``collective_log`` of (kind, dtype, shape) a result tensor.

    A storage is counted once, from the operator that first returns it to
    the moment its last reference dies (PyTorch keeps one Python object a
    storage while any tensor holds it, so a finalizer sees that moment,
    autograd's saved tensors included)."""

    def __init__(self, live=()):
        super().__init__()
        self.moved = 0
        self.now = 0
        self.peak = 0
        self.collectives: dict = {}
        self.collective_calls = 0
        self.collective_log: list = []
        self._held: dict = {}  # id of a storage -> its finalizer
        for t in live:
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        nbytes = st.nbytes()
        self._held[key] = weakref.finalize(st, self._free, key, nbytes)
        self.now += nbytes
        self.peak = max(self.peak, self.now)

    def _free(self, key: int, nbytes: int) -> None:
        del self._held[key]
        self.now -= nbytes

    def __exit__(self, *exc):
        for fin in self._held.values():  # storages that outlive the count
            fin.detach()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.namespace == "c10d":
            results = [t for t in tree_leaves(args[0]) if isinstance(t, torch.Tensor)]
            sent = sum(_unique_bytes(t) for t in results)
            self.collectives[name] = self.collectives.get(name, 0) + sent
            self.collective_log += [(COLLECTIVE_KINDS.get(name, name), str(t.dtype),
                                     tuple(t.shape)) for t in results]
            self.collective_calls += 1
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._hold(t)
        if not func.is_view and name not in _NO_TRAFFIC:
            self.moved += sum(_unique_bytes(t) for t in tree_leaves((args, kwargs))
                              if isinstance(t, torch.Tensor))
            self.moved += sum(_unique_bytes(t) for t in outs)
        return out


def trace(fn, *args, live=()) -> dict:
    """Run ``fn(*args)`` under ``FlopCounterMode`` and a :class:`Meter`:
    {flops, bytes_moved, peak_live_bytes, collectives, collective_calls,
    out}.  ``live``: the tensors alive before the call (its arguments)."""
    flops = FlopCounterMode(display=False)
    meter = Meter(live)
    with flops, meter:
        out = fn(*args)
    return {"flops": int(flops.get_total_flops()), "bytes_moved": meter.moved,
            "peak_live_bytes": meter.peak, "collectives": dict(meter.collectives),
            "collective_calls": meter.collective_calls,
            "collective_log": meter.collective_log, "out": out}


# --------------------------------------------------------------------------
# one LM cell
# --------------------------------------------------------------------------


def tree_bytes(tensors, specs, mesh) -> int:
    """Per-device bytes of a tree of tensors sharded by a parallel tree of
    shardings."""
    sizes = map_leaves(lambda _, spec, t: shard_bytes(t.shape, t.dtype, spec, mesh),
                       specs, tensors)
    return sum(n for _, n in leaves(sizes))


def spec_bytes(specs, mesh) -> int:
    """Per-device bytes of a tree of (shape, dtype, sharding) leaves, such
    as a family module's ``cache_specs``."""
    return sum(shard_bytes(*leaf, mesh) for _, leaf in leaves(specs))


def _params(shapes, f32_entries, masters: bool, device):
    """Zeroed parameters of ``shapes`` (float32 masters, or the port's
    serving dtypes: bf16 but ``f32_entries``).  ``init`` is not used: its
    generator needs a real device."""
    def zeros(name, shape):
        f32 = masters or name in f32_entries
        return torch.zeros(shape, dtype=torch.float32 if f32 else torch.bfloat16, device=device)

    return map_leaves(zeros, shapes)


def lm_step(cfg, mesh, shape, device=META, rank_mesh=None) -> dict:
    """The step of one LM cell and its arguments, on ``device`` (the meta
    device for the dry run; the card for ``chip_smoke.py``'s check):
    {fn, args, arg_bytes, out_bytes}, bytes per device on ``mesh``.
    ``shape``: a name in ``SHAPES`` or a dict of its form.  With a
    ``rank_mesh`` (a ``RankMesh`` of ``mesh``'s shape), the step is the
    meshed one: its parameters (and a training step's optimizer state)
    this rank's shards, the global batch split as ``input_specs._dp``
    says, a decode step's cache this rank's shard.

    The model functions are the family module's, not ``registry.get_model``'s:
    ``resolve_device`` refuses the meta device, and should."""
    from repro_torch.models.registry import get_module
    from repro_torch.models.transformer import _masks
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import get_optimizer

    mod = get_module(cfg)
    _masks(cfg, torch.device(device))  # made once a (config, device) and kept, as
    # every step after a process's first finds them
    info = _info(shape)
    kind, B, S = info["kind"], info["batch"], info["seq"]
    pshapes, pspecs = param_shapes(cfg), param_specs(cfg)
    params = _params(pshapes, mod.F32_ENTRIES, kind == "train", device)
    p_bytes = tree_bytes(params, pspecs, mesh)
    logits_bytes = shard_bytes((B, cfg.padded_vocab), torch.float32, (_dp(mesh, B), None), mesh)
    if kind == "train":
        opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
        s_bytes = tree_bytes(opt.init(params), opt.state_specs(pspecs, pshapes), mesh)
    if rank_mesh is not None:
        params = map_leaves(lambda _, t, spec: torch.zeros(shard_shape(t.shape, spec, mesh),
                                                          dtype=t.dtype, device=device),
                            params, pspecs)
    if kind != "decode":
        batch, bspecs, dp = batch_specs(cfg, mesh, info)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in batch.items()}
        b_bytes = tree_bytes(batch, bspecs, mesh)
        kw = {} if rank_mesh is None else {"mesh": rank_mesh, "dp": dp}
    if kind == "train":
        state = opt.init(params)
        step = torch.zeros((), dtype=torch.int32, device=device)
        model = SimpleNamespace(cfg=cfg, train_loss=lambda p, b, **k: mod.train_loss(cfg, p, b,
                                                                                   **k))
        return {"fn": make_train_step(model, opt, **kw), "args": (params, state, step, batch),
                "arg_bytes": p_bytes + s_bytes + 4 + b_bytes,
                "out_bytes": p_bytes + s_bytes + 4 + 4}  # in place, and the f32 loss
    if kind == "prefill":
        cspecs = decode_specs(cfg, mesh, info)[1]  # the cache prefill returns
        return {"fn": lambda p, b: mod.prefill(cfg, p, b, S, **kw), "args": (params, batch),
                "arg_bytes": p_bytes + b_bytes,
                "out_bytes": logits_bytes + spec_bytes(cspecs, mesh)}
    cache, cspecs, token, tspec, _, dp = decode_specs(cfg, mesh, info)
    if rank_mesh is not None:
        kw = {"enc_seq": S // cfg.frontend_len_div} if cfg.family == "encdec" else {}
        cache = {**mod.alloc_cache(cfg, B, S, device, mesh=rank_mesh, dp=dp, **kw),
                 "length": cache["length"]}
        return {"fn": lambda p, c, t: mod.decode_step(cfg, p, c, t, mesh=rank_mesh, dp=dp),
                "args": (params, cache, token),
                "arg_bytes": p_bytes + spec_bytes(cspecs, mesh)
                + shard_bytes(token.shape, token.dtype, tspec, mesh),
                "out_bytes": logits_bytes + spec_bytes(cspecs, mesh)}
    if device != META:
        cache = {**zeros_of(cspecs, device), "length": cache["length"]}
        token = torch.zeros(token.shape, dtype=token.dtype, device=device)
    c_bytes = spec_bytes(cspecs, mesh)
    return {"fn": lambda p, c, t: mod.decode_step(cfg, p, c, t), "args": (params, cache, token),
            "arg_bytes": p_bytes + c_bytes + shard_bytes(token.shape, token.dtype, tspec, mesh),
            "out_bytes": logits_bytes + c_bytes}


def trace_lm(cfg, mesh, shape) -> dict:
    """Trace one LM cell's step on the meta device: the global counts of
    :func:`trace` and the step's per-device argument and output bytes."""
    step = lm_step(cfg, mesh, shape)
    args = step["args"]
    got = trace(step["fn"], *args, live=list(_tensors(args)))
    got.pop("out")
    return {**got, "arg_bytes": step["arg_bytes"], "out_bytes": step["out_bytes"]}


def trace_meshed(cfg, axis_names, sizes, shape) -> dict:
    """Trace the meshed step of ``cfg``'s cell ``shape`` (decode, prefill or
    training) on rank 0 of a fake process group of ``prod(sizes)`` ranks on
    the meta device: :func:`trace`'s counts for that rank, the collectives
    by kind (JAX's names) with their ``total``, and the rank's argument and
    output bytes.  A serving step runs under ``torch.no_grad``, as served."""
    from repro_torch.launch.mesh import Mesh

    with fake_world(math.prod(sizes)):
        rank_mesh = RankMesh(sizes, axis_names, device_type="cpu")
        step = lm_step(cfg, Mesh(tuple(axis_names), tuple(sizes)), shape,
                       rank_mesh=rank_mesh)
        args = step["args"]
        serving = _info(shape)["kind"] != "train"
        with torch.no_grad() if serving else contextlib.nullcontext():
            got = trace(step["fn"], *args, live=list(_tensors(args)))
    got.pop("out")
    coll = {}
    for name, n in got["collectives"].items():
        kind = COLLECTIVE_KINDS.get(name, name)
        coll[kind] = coll.get(kind, 0) + n
    coll["total"] = sum(coll.values())
    return {**got, "collectives": coll, "arg_bytes": step["arg_bytes"],
            "out_bytes": step["out_bytes"]}


def probe_lm(cfg, mesh, shape, layers=PROBE_LAYERS, tracer=None) -> dict:
    """The counts of ``tracer(cfg, mesh, shape)`` (:func:`trace_lm`, or
    :func:`trace_meshed` on ``mesh``'s axes) for ``cfg.n_layers`` layers,
    from whole-length traces of ``cfg`` cut to each count in ``layers``
    (the first two fix a line in the layer count, the others must lie on
    it to the integer, else ``ValueError``): FLOPs, bytes moved, the peak,
    and a meshed trace's collective calls and bytes of each kind;
    argument and output bytes from the cell's own config and shapes.

    Every layer runs the same operators on the same shapes, and the top
    (embedding, head, loss) is the same whatever the depth, so FLOPs,
    bytes moved and collectives are affine in the layer count.  So is the
    peak, once the step's fullest moment falls in the same layer's work at
    every depth (the top layer's backward, a layer's WKV): one layer alone
    is not such a depth, which is why the probe starts at two."""
    tracer = tracer or trace_lm
    runs = [tracer(dataclasses.replace(cfg, n_layers=n), mesh, shape) for n in layers]
    for r in runs:
        r.update({f"collectives.{k}": v for k, v in r["collectives"].items()})
    metrics = ("flops", "bytes_moved", "peak_live_bytes", "collective_calls") + tuple(
        f"collectives.{k}" for k in runs[0]["collectives"])

    def at(metric, n):
        (n0, m0), (n1, m1) = [(x, r[metric]) for x, r in zip(layers[:2], runs[:2])]
        v = m0 + Fraction(m1 - m0, n1 - n0) * (n - n0)
        if v.denominator != 1:
            raise ValueError(f"{metric} is not integral at {n} layers on the probe's line")
        return int(v)

    for n, r in zip(layers[2:], runs[2:]):
        for m in metrics:
            if at(m, n) != r.get(m, 0):
                raise ValueError(f"{cfg.name}: {m} is not affine in the layer count: "
                                 f"{r.get(m, 0)} traced at {n} layers, {at(m, n)} on the "
                                 f"line through {layers[:2]}")
    full = lm_step(cfg, mesh, shape, device=META)
    solved = {m: at(m, cfg.n_layers) for m in metrics}
    return {**{m: solved[m] for m in metrics if not m.startswith("collectives.")},
            "collectives": {m.split(".", 1)[1]: v for m, v in solved.items()
                            if m.startswith("collectives.")},
            "arg_bytes": full["arg_bytes"], "out_bytes": full["out_bytes"],
            "probe": {"layers": list(layers), "rule": "affine in the layer count, checked "
                      "at the third", "solved_for": cfg.n_layers}}


def wkv_flops(cfg, info) -> int:
    """JAX's closed form for the WKV recurrence (``analytic_adjustments``):
    10 FLOP a (step, head, dh, dh), three passes for training."""
    H, dh = cfg.d_model // cfg.head_dim, cfg.head_dim
    steps = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    return 10 * steps * H * dh * dh * (3 if info["kind"] == "train" else 1) * cfg.n_layers


def lower_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    reason = skip_reason(cfg, shape)
    if reason:
        return {"status": "SKIP", "arch": arch, "shape": shape, "mesh": mesh_name,
                "reason": reason}
    mesh = make_production_mesh(multi_pod=multi_pod)
    info = SHAPES[shape]
    kind = info["kind"]
    n = mesh.size
    t0 = time.time()
    tracer = lambda c, m, sh: trace_meshed(c, m.axis_names, m.sizes, sh)  # noqa: E731
    if cfg.family == "rwkv" and kind != "decode":
        got = probe_lm(cfg, mesh, shape, tracer=tracer)  # the per-token WKV (module docstring)
    else:
        got = tracer(cfg, mesh, shape)
    pshapes = param_shapes(cfg)
    result = {
        "status": "OK", "arch": arch, "shape": shape, "mesh": mesh_name, "n_chips": n,
        "kind": kind,
        "tokens_per_step": info["batch"] * (info["seq"] if kind != "decode" else 1),
        "params_total": count_params(pshapes),
        "params_active": count_active_params(cfg, pshapes),
        "trace_seconds": round(time.time() - t0, 1),
        "memory": {"argument_size_in_bytes": got["arg_bytes"],
                   "output_size_in_bytes": got["out_bytes"]},
        "flops_per_device": got["flops"],
        "bytes_moved_per_device": got["bytes_moved"],
        "peak_live_bytes_per_device": got["peak_live_bytes"],
        "collectives_per_device": got["collectives"],
        "collective_calls_per_device": got["collective_calls"],
        "collectives_note": f"the meshed {kind} step, rank 0 of a fake group",
    }
    if "probe" in got:
        result["probe"] = got["probe"]
    if cfg.family == "rwkv":
        result["uncounted_flops"] = {
            "wkv_recurrence": wkv_flops(cfg, info),
            "note": "JAX's closed form for the elementwise WKV recurrence, global; "
                    "FlopCounterMode counts matrix products only"}
    return result


# --------------------------------------------------------------------------
# the paper's own workload
# --------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(size: int):
    """A ``torch.distributed`` default group of ``size`` ranks, this process
    rank 0, whose collectives move nothing: ``torch.testing._internal``'s
    fake process group (its import path is pinned by a test)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def trace_gbdt(wl, gcfg, n_ranks: int) -> dict:
    """Trace rank 0 of ``n_ranks`` training the workload ``wl`` with
    ``gcfg``: one shard of ``wl.rows // n_ranks`` rows on the meta device,
    data-parallel over a fake group.  Returns :func:`trace`'s counts (the
    collectives per device: every rank issues the same) and the shard's
    argument and output bytes.

    The trainer takes its plain histogram path (``hist_method="ref"``):
    the meta device has no kernel to launch.  That is the trace's choice,
    not a fallback from the card; the histograms' shapes, and so every
    collective, are the kernel's."""
    from repro_torch.gbdt.trainer import train

    rows = wl.rows // n_ranks
    gcfg = dataclasses.replace(gcfg, hist_method="ref")
    bins = torch.empty((rows, wl.n_features), dtype=torch.uint8, device=META)
    y = torch.empty((rows,), dtype=torch.float32, device=META)
    edges = torch.empty((wl.n_features, wl.n_bins - 1), dtype=torch.float32, device=META)
    with fake_world(n_ranks) as group:
        got = trace(lambda: train(gcfg, bins, y, edges, axis_name=group), live=(bins, y, edges))
    out = got.pop("out")
    got["arg_bytes"] = sum(t.nbytes for t in (bins, y, edges))
    forest, history, aux = out
    got["out_bytes"] = sum(t.nbytes for t in _tensors([vars(forest), history, aux]))
    return got


def run_gbdt_cell(multi_pod: bool) -> dict:
    """Data-parallel ToaD training on a fake group of 256 (512) ranks, rank
    0 traced over all of the configuration's rounds."""
    from repro_torch.configs.toad_gbdt import config

    wl = config()
    ndev = 512 if multi_pod else 256
    gcfg = dataclasses.replace(
        wl.gbdt, hist_dtype=os.environ.get("TOAD_HIST_DTYPE", "f32"),
        hist_quant_bits=int(os.environ.get("TOAD_HIST_QUANT", "0")))
    t0 = time.time()
    got = trace_gbdt(wl, gcfg, ndev)
    R = wl.gbdt.n_rounds
    coll = dict(got["collectives"])
    coll["total"] = sum(coll.values())
    return {
        "status": "OK", "arch": "toad_gbdt",
        "shape": f"rows{wl.rows}_d{wl.n_features}_b{wl.n_bins}_depth{wl.gbdt.max_depth}_r{R}",
        "mesh": f"{ndev}(data)", "n_chips": ndev, "kind": "gbdt_train",
        "trace_seconds": round(time.time() - t0, 1),
        "memory": {"argument_size_in_bytes": got["arg_bytes"],
                   "output_size_in_bytes": got["out_bytes"]},
        "flops_per_device": got["flops"],
        "bytes_moved_per_device": got["bytes_moved"],
        "peak_live_bytes_per_device": got["peak_live_bytes"],
        "collectives_per_device": coll,
        "collective_calls_per_device": got["collective_calls"],
        "hist_quant_bits": gcfg.hist_quant_bits, "hist_dtype": gcfg.hist_dtype,
        "rounds": R,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    t0 = time.time()
    try:
        if args.arch == "toad_gbdt":
            res = run_gbdt_cell(args.mesh == "multi")
        else:
            res = lower_cell(args.arch, args.shape, args.mesh == "multi")
    except Exception as e:  # noqa: BLE001 — record the failure, don't crash the sweep
        import traceback

        res = {"status": "FAIL", "arch": args.arch, "shape": args.shape,
               "mesh": args.mesh, "error": str(e)[:2000],
               "traceback": traceback.format_exc()[-3000:]}
    res["wall_seconds"] = round(time.time() - t0, 1)

    text = json.dumps(res, indent=2)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    if res["status"] == "FAIL":
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
