"""Optimizers of the port (``repro.train.optimizer``): AdamW and factored
Adafactor over the port's parameter trees (dicts and lists of tensors).

Each is an :class:`Optimizer` of ``init(params) -> state`` and
``update(grads, state, params, step) -> (params, state)``, with JAX's
formulas in JAX's order, in float32.  ``update`` writes the new
parameters and state into the given tensors under ``torch.no_grad()``
and returns them: the counterpart of the JAX loop donating both
(``donate_argnums``), so a step holds one set of masters and state, not
two.  ``step`` is an integer tensor on the parameters' device, so no
update reads back to the host.

``state_specs(param_specs, param_shapes=None)`` gives the state's
sharding tree from the parameters' (``models.param_specs``: a tuple a
leaf, one entry a dimension), as JAX's does for its ``PartitionSpec``
trees: the state inherits the parameters' shardings (ZeRO-style).  On a
device mesh the state is live shards by those specs: each rank's
``init`` of its parameter shards is its shard of the whole state, and
``update(..., mesh=, specs=, shapes=)`` updates it in place from the
rank's gradient shards.  AdamW is elementwise, so a shard updates as the
whole does (an uneven split's padding stays zero).  Adafactor's row and
column means and its per-leaf RMS clip reduce over dimensions a mesh
may split: each sums its shard, all-reduces over the axes that split the
dimension and divides by the whole length, with the padding of an
uneven split masked out (``g * g + eps`` would make it count).  A
dimension no axis of more than one rank splits reduces as it does
without a mesh, to the bit.  ``torch.optim.AdamW`` is not used: it
decays as ``p *= 1 - lr * wd`` before the step and divides by
``sqrt(v) / sqrt(c2) + eps``, which rounds differently.

Adafactor stores row/column second-moment factors for leaves of rank >= 2
(``vr`` over the last dimension reduced, ``vc`` over the second-to-last):
O(sum of dims) instead of O(prod of dims).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models.base import _axis_names, full_spec, map_leaves


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # (grads, state, params, step, mesh=None, specs=None, shapes=None)
    update: Callable[..., tuple]
    state_specs: Callable[..., Any]  # (param specs, param shapes) -> state specs


def _split_axes(spec, rank: int, mesh) -> list:
    """A leaf of ``rank`` dimensions sharded as ``spec``: for each
    dimension, the axes of more than one rank that split it."""
    return [[a for a in _axis_names(e) if mesh.axis_size(a) > 1]
            for e in full_spec(spec, rank)]


def _valid(p: torch.Tensor, whole, spec, mesh):
    """A bool mask of the entries of the shard ``p`` (of a leaf of shape
    ``whole``) that are not an uneven split's padding; None if none is."""
    from repro_torch.launch.mesh import entry_index

    mask = None
    for d, (c, n, e) in enumerate(zip(p.shape, whole, full_spec(spec, p.dim()))):
        lo = entry_index(e, mesh) * c
        if lo + c <= n:
            continue
        keep = (torch.arange(c, device=p.device) < n - lo).reshape(
            [c if i == d else 1 for i in range(p.dim())])
        mask = keep if mask is None else mask & keep
    return mask


def _summed(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``t`` summed over each axis of ``axes`` in turn, in place."""
    from repro_torch.distributed.collectives import all_reduce_sum

    for a in axes:
        t = all_reduce_sum(t, mesh.group(a))
    return t


def tree_map(fn, *trees):
    """``fn`` over the leaves of parallel trees (nests of dicts and lists),
    the first tree giving the structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(first))]
    return fn(*trees)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step, mesh=None, specs=None, shapes=None):
        t = step.to(torch.float32) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)              # m = b1 m + (1 - b1) g
            v.mul_(b2).add_((1 - b2) * g * g)          # v = b2 v + (1 - b2) g g
            u = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p
            p.sub_(lr * u)                             # p = p - lr u

        tree_map(upd, grads, state["m"], state["v"], params)
        return params, state

    def state_specs(param_specs, param_shapes=None):
        return {"m": param_specs, "v": param_specs}

    return Optimizer(init, update, state_specs)


def adafactor(lr=3e-4, eps=1e-30, decay=0.8, clip=1.0) -> Optimizer:
    """Factored second moments for rank>=2 leaves; full for vectors."""

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def one(p):
            def z(shape):
                return torch.zeros(shape, dtype=torch.float32, device=p.device)

            if _factored(p):
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return tree_map(one, params)

    @torch.no_grad()
    def update(grads, state, params, step, mesh=None, specs=None, shapes=None):
        """On a ``mesh``, ``specs`` and ``shapes`` are the parameters'
        shardings and whole shapes (``param_specs``, ``param_shapes``)."""
        t = step.to(torch.float32) + 1.0
        beta = 1.0 - t ** -decay

        def upd(g, s, p, spec, whole):
            g = g.to(torch.float32)
            g2 = g * g + eps
            axes = [] if mesh is None else _split_axes(spec, p.dim(), mesh)
            if any(axes):
                valid = _valid(p, whole, spec, mesh)
                if valid is not None:
                    g2 = torch.where(valid, g2, torch.zeros((), device=g2.device))

            def mean(x, dim, of, keepdim=False):
                """``x``'s mean over its dimension ``dim``, which is p's
                dimension ``of``: the whole length's, summed over the axes
                that split it."""
                if not axes or not axes[of]:
                    return torch.mean(x, dim=dim, keepdim=keepdim)
                return _summed(torch.sum(x, dim=dim, keepdim=keepdim), axes[of],
                               mesh) / whole[of]

            if _factored(p):
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * mean(g2, -1, -1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * mean(g2, -2, -2))
                vr, vc = s["vr"], s["vc"]
                r = vr / torch.clamp(mean(vr, -1, -2, keepdim=True), min=eps)
                u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :] + eps)
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g / (torch.sqrt(s["v"]) + eps)
            split = sorted({a for d in axes for a in d})
            if split:
                norm = torch.sqrt(_summed(torch.sum(u * u), split, mesh) / math.prod(whole))
            else:
                norm = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(norm / clip, min=1.0)
            p.sub_(lr * u)

        # the state has one more level a parameter leaf: walk the grads' tree
        # and hand each leaf its state dict whole
        def walk(g, s, p, spec, whole):
            if isinstance(g, dict):
                for k in g:
                    walk(g[k], s[k], p[k], spec and spec[k], whole and whole[k])
            elif isinstance(g, (list, tuple)):
                for i, (gi, si, pi) in enumerate(zip(g, s, p)):
                    walk(gi, si, pi, spec and spec[i], whole and whole[i])
            else:
                upd(g, s, p, spec, whole)

        walk(grads, state, params, specs, shapes)
        return params, state

    def state_specs(param_specs, param_shapes=None):
        """Factoring follows the parameter's *rank* (``init``'s rule), not
        the spec's length: a spec that leaves trailing dimensions out is
        padded with ``None`` (replicated) first."""
        if param_shapes is None:
            raise ValueError("adafactor.state_specs needs param shapes")

        def one(spec, shape):
            rank = len(shape)
            padded = tuple(spec) + (None,) * (rank - len(spec))
            if rank >= 2:
                return {"vr": padded[:-1], "vc": padded[:-2] + padded[-1:]}
            return {"v": padded}

        return map_leaves(lambda _, spec, shape: one(spec, shape), param_specs, param_shapes)

    return Optimizer(init, update, state_specs)


def get_optimizer(name: str, lr: float = 3e-4) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise ValueError(name)
