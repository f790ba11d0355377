"""The port's restart-exact training loop (``repro.train.loop``).

* a stateless data plane: ``batch_fn(step)`` is a pure function of
  (seed, step), so a restart replays exactly;
* periodic atomic checkpoints (``distributed.checkpoint``, the JAX
  package's on-disk format) of the parameters and the optimizer state;
* resume from the latest checkpoint on start: a run that "crashes" and
  restarts ends on the parameters of one that does not.

One step is ``make_train_step``: the loss and the gradient of every float
leaf (of a bf16 compute copy with ``grad_dtype="bf16"``), then the
optimizer's update in place on the float32 masters.  The loop reads back
one float a step, the loss, as JAX's ``float(loss)`` does.

On a device mesh (``mesh=``, a ``launch.mesh.RankMesh``; every family)
every rank runs the step on its shards of the masters and the
optimizer state (``param_specs``, ``state_specs``) and the global batch,
as JAX's ``make_train_step`` runs jitted under ``in_shardings``: the
model's ``train_loss`` returns the global mean, a weight gathered over
``"data"`` gets its gradient reduce-scattered in the backward, and each
other leaf's gradient is summed here over the batch's axes that do not
split it (``"pod"`` too on a two-pod mesh).  ``fit`` saves and restores
meshed checkpoints (``distributed.checkpoint``), which restore onto any
mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.models.base import (
    MESH_DP,
    _axis_names,
    batch_axes,
    map_leaves,
    param_shapes,
    param_specs,
)
from repro_torch.train.optimizer import _summed, get_optimizer, tree_map


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _batch_sum(grads, specs, mesh, dp):
    """Each gradient leaf (this rank's rows' share) summed, in place, over
    the batch's axes of more than one rank that do not split the leaf; a
    leaf split over one (an FSDP gather's) is summed over it already."""
    axes = [a for a in _axis_names(batch_axes(mesh, dp)) if mesh.axis_size(a) > 1]

    def one(_, g, spec):
        own = {a for e in spec for a in _axis_names(e)}
        return _summed(g.contiguous(), [a for a in axes if a not in own], mesh)

    return map_leaves(one, grads, specs)


def state_layout(cfg, optimizer) -> tuple:
    """(shardings, whole shapes) of the checkpointed tree ``{"params",
    "opt"}``: ``param_specs`` and the optimizer's ``state_specs``, and the
    shapes of the whole tree (the state's from ``init`` on the meta
    device)."""
    pspecs, pshapes = param_specs(cfg), param_shapes(cfg)
    meta = map_leaves(lambda _, shape: torch.empty(shape, device="meta"), pshapes)
    oshapes = tree_map(lambda t: tuple(t.shape), optimizer.init(meta))
    return ({"params": pspecs, "opt": optimizer.state_specs(pspecs, pshapes)},
            {"params": pshapes, "opt": oshapes})


def make_train_step(model, optimizer, mesh=None, dp=MESH_DP):
    """``train_step(params, opt_state, step, batch) -> loss``: updates
    ``params`` and ``opt_state`` in place and adds one to the integer
    tensor ``step``.  With ``grad_dtype == "bf16"`` the gradient is taken
    of a bf16 compute copy of every float32 leaf (JAX's mixed-precision
    branch, which halves a gradient all-reduce) and the float32 masters
    are updated from it.  On a ``mesh`` (module docstring) ``params`` and
    ``opt_state`` are this rank's shards and ``batch`` the global batch,
    split over ``dp``.  ``train_step.grads(params, batch)`` is the step's
    (loss, gradient tree) alone, every leaf's gradient summed as the
    update takes it."""
    bf16_grads = getattr(model.cfg, "grad_dtype", "f32") == "bf16"
    specs = shapes = None
    if mesh is not None:
        specs, shapes = param_specs(model.cfg), param_shapes(model.cfg)

    def grads(params, batch):
        if bf16_grads:
            compute = tree_map(lambda p: p.detach().to(torch.bfloat16)
                               if p.dtype == torch.float32 else p.detach(), params)
        else:
            compute = tree_map(lambda p: p.detach(), params)
        leaves = _leaves(compute)
        for t in leaves:
            t.requires_grad_(True)
        if mesh is None:
            loss = model.train_loss(compute, batch)
        else:
            loss = model.train_loss(compute, batch, mesh=mesh, dp=dp)
        g = _unflatten(params, torch.autograd.grad(loss, leaves))
        if mesh is not None:
            g = _batch_sum(g, specs, mesh, dp)
        return loss.detach(), g

    def train_step(params, opt_state, step, batch):
        loss, g = grads(params, batch)
        if mesh is None:
            optimizer.update(g, opt_state, params, step)
        else:
            optimizer.update(g, opt_state, params, step, mesh=mesh, specs=specs, shapes=shapes)
        step.add_(1)
        return loss

    train_step.grads = grads
    return train_step


def fit(model, batch_fn, *, steps: int, ckpt_dir: str | None = None,
        ckpt_every: int = 50, seed: int = 0, step_ms: list | None = None,
        dp=MESH_DP, mesh=None):
    """Train ``model`` (from ``get_model``) for ``steps``, resuming from
    ``ckpt_dir`` if it holds a checkpoint.

    ``batch_fn(step)`` -> batch dict on the model's device (a pure function
    of the step: restart-exact).  The masters come from ``model.init(seed,
    masters=True)``; on a ``mesh`` (the ambient mesh of JAX's ``fit``),
    this rank's shards of them, the batch split over ``dp`` (JAX's
    argument), and the checkpoints saved and restored meshed.  With
    ``step_ms`` (a list), each step's time in ms is
    appended: from the batch to the loss read back (which waits for the
    step's last kernel), by CUDA events on the card.  Returns (params,
    losses list)."""
    optimizer = get_optimizer(model.cfg.optimizer, model.cfg.learning_rate)
    params = model.init(seed, masters=True, mesh=mesh)
    opt_state = optimizer.init(params)
    specs, shapes = state_layout(model.cfg, optimizer) if mesh is not None else (None, None)
    start = 0
    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            state = ckpt.restore(ckpt_dir, latest, {"params": params, "opt": opt_state},
                                 device=model.device, mesh=mesh, specs=specs)
            params, opt_state = state["params"], state["opt"]
            start = latest
    step = torch.tensor(start, dtype=torch.int32, device=model.device)

    train_step = make_train_step(model, optimizer, mesh, dp)
    losses = []
    cuda = model.device.type == "cuda"
    for s in range(start, steps):
        if step_ms is not None:
            t0 = torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter()
            if cuda:
                t0.record()
        loss = train_step(params, opt_state, step, batch_fn(s))
        losses.append(float(loss))
        if step_ms is not None:
            if cuda:
                t1 = torch.cuda.Event(enable_timing=True)
                t1.record()
                t1.synchronize()
                step_ms.append(t0.elapsed_time(t1))
            else:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        if ckpt_dir is not None and (s + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, s + 1, {"params": params, "opt": opt_state}, mesh=mesh,
                      specs=specs, shapes=shapes)
    return params, losses


def lm_batch_fn(cfg, n_docs: int, seq: int, batch: int, seed: int = 0, device="cuda"):
    """Synthetic LM data: deterministic (seed, step) -> a batch of token ids
    drawn from a Zipfian unigram model with local structure (bigram copy),
    the JAX package's draws to the bit, as int32 tensors on ``device``."""
    from repro_torch._device import resolve_device

    vocab = cfg.vocab
    device = resolve_device(device)

    def batch_fn(step: int):
        rng = np.random.default_rng(np.uint64(seed) * np.uint64(999983) + np.uint64(step))
        ranks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
        toks = np.minimum(ranks, vocab - 1).astype(np.int32)
        # inject copy structure so the model has something learnable
        toks[:, 2::7] = toks[:, 1:-1:7]
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(device)}

    return batch_fn
