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

JAX's ``state_specs`` (the state's ``PartitionSpec`` tree for a sharded
mesh) has no counterpart on one card and is left out; the launch tooling
(``dryrun``) is its only user.  ``torch.optim.AdamW`` is not used: it
decays as ``p *= 1 - lr * wd`` before the step and divides by
``sqrt(v) / sqrt(c2) + eps``, which rounds differently.

Adafactor stores row/column second-moment factors for leaves of rank >= 2
(``vr`` over the last dimension reduced, ``vc`` over the second-to-last):
O(sum of dims) instead of O(prod of dims).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple]  # (grads, state, params, step)


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
    def update(grads, state, params, step):
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

    return Optimizer(init, update)


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
    def update(grads, state, params, step):
        t = step.to(torch.float32) + 1.0
        beta = 1.0 - t ** -decay

        def upd(g, s, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if _factored(p):
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2))
                vr, vc = s["vr"], s["vc"]
                r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
                u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :] + eps)
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g / (torch.sqrt(s["v"]) + eps)
            norm = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(norm / clip, min=1.0)
            p.sub_(lr * u)

        # the state has one more level a parameter leaf: walk the grads' tree
        # and hand each leaf its state dict whole
        def walk(g, s, p):
            if isinstance(g, dict):
                for k in g:
                    walk(g[k], s[k], p[k])
            elif isinstance(g, (list, tuple)):
                for gi, si, pi in zip(g, s, p):
                    walk(gi, si, pi)
            else:
                upd(g, s, p)

        walk(grads, state, params)
        return params, state

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float = 3e-4) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise ValueError(name)
