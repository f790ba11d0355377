"""Losses for the GBDT trainer: gradients/hessians, base scores, metrics
(the port's counterpart of ``repro.gbdt.losses``).

Multiclass follows the paper (and LightGBM): one ensemble per class trained
against softmax gradients.  Every function takes and returns tensors on the
device of its inputs.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Loss:
    name: str
    n_ensembles: int

    def base_score(self, y: torch.Tensor) -> torch.Tensor:
        s, c = self.base_stats(y)
        return self.base_from_stats(s, c)

    def base_stats(self, y: torch.Tensor):
        """(sum vector, count) — summed across shards for data-parallel
        training."""
        raise NotImplementedError

    def base_from_stats(self, s: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def grad_hess(self, y: torch.Tensor, preds: torch.Tensor):
        raise NotImplementedError

    def metric(self, y: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def _count(y: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(y.shape[0]), dtype=torch.float32, device=y.device)


@dataclasses.dataclass(frozen=True)
class SquaredError(Loss):
    name: str = "mse"
    n_ensembles: int = 1

    def base_stats(self, y):
        return torch.sum(y)[None], _count(y)

    def base_from_stats(self, s, count):
        return s / count

    def grad_hess(self, y, preds):
        g = preds[:, 0] - y
        h = torch.ones_like(g)
        return g[:, None], h[:, None]

    def metric(self, y, preds):
        """R^2 score (higher is better), as in the paper's regression plots."""
        p = preds[:, 0]
        ss_res = torch.sum((y - p) ** 2)
        ss_tot = torch.sum((y - torch.mean(y)) ** 2)
        return 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)


@dataclasses.dataclass(frozen=True)
class Logistic(Loss):
    name: str = "logistic"
    n_ensembles: int = 1

    def base_stats(self, y):
        return torch.sum(y)[None], _count(y)

    def base_from_stats(self, s, count):
        p = torch.clamp(s / count, 1e-6, 1 - 1e-6)
        return torch.log(p / (1 - p))

    def grad_hess(self, y, preds):
        s = torch.sigmoid(preds[:, 0])
        g = s - y
        h = s * (1.0 - s)
        return g[:, None], h[:, None]

    def metric(self, y, preds):
        pred_label = (preds[:, 0] > 0).to(y.dtype)
        return torch.mean((pred_label == y).float())


@dataclasses.dataclass(frozen=True)
class Softmax(Loss):
    """One ensemble per class (paper Sec. 4.2: 'one ensemble per class')."""

    name: str = "softmax"
    n_ensembles: int = 2

    def _onehot(self, y, dtype):
        return torch.nn.functional.one_hot(y.long(), self.n_ensembles).to(dtype)

    def base_stats(self, y):
        return torch.sum(self._onehot(y, torch.float32), dim=0), _count(y)

    def base_from_stats(self, s, count):
        prior = torch.clamp(s / count, 1e-6, 1.0)
        return torch.log(prior)

    def grad_hess(self, y, preds):
        p = torch.softmax(preds, dim=-1)
        g = p - self._onehot(y, p.dtype)
        h = 2.0 * p * (1.0 - p)  # XGBoost's diagonal upper bound
        return g, h

    def metric(self, y, preds):
        return torch.mean((torch.argmax(preds, dim=-1) == y.long()).float())


def make_loss(task: str, n_classes: int = 0) -> Loss:
    if task == "regression":
        return SquaredError()
    if task == "binary":
        return Logistic()
    if task == "multiclass":
        if n_classes < 2:
            raise ValueError(f"multiclass needs n_classes >= 2, got {n_classes}")
        return Softmax(n_ensembles=n_classes)
    raise ValueError(f"unknown task {task!r}")
