"""Faults planted in the program's timed path, to show that a run judges
them not correct (the tests, and ``control.py --fault`` on the card).

Training (``fit``):

  * ``state_unchanged``: every round takes its gradients from the fit's
    first scores, as if each round returned the state it was given;
  * ``half_batch``: every histogram leaves out the odd rows and doubles the
    rest (the mean taken over half the batch);
  * ``answer_altered``: the fitted forest's leaf values come out 1 %
    larger than trained.

Scoring (``score``):

  * ``half_batch``: the predictor scores the first half of a request's rows
    and repeats those scores for the second half;
  * ``answer_altered``: the first row's first score comes out 0.1 (the size
    of one leaf value) larger.

The controls (``CONTROLS``), one precision step below the configurations'
float32, are planted the same way:

  * training: the program's own bfloat16 path, ``hist_dtype="bf16"`` (the
    gradients and hessians rounded to bfloat16 before the histograms);
  * scoring: the reference put in the predictor's place, its walk with
    rows, thresholds and leaf values in bfloat16
    (``reference.forest.score_low``).

Each is a context manager that patches module attributes and restores them
on exit.
"""

from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def fit_state_unchanged():
    from repro_torch.gbdt.losses import Logistic, Softmax

    first = {}
    stacks = contextlib.ExitStack()
    for cls in (Logistic, Softmax):
        orig = cls.grad_hess

        def stale(self, y, preds, _orig=orig):
            key = (y.data_ptr(), y.shape[0])
            if key not in first:
                first[key] = preds.clone()
            return _orig(self, y, first[key])

        stacks.enter_context(_patched(cls, "grad_hess", stale))
    with stacks:
        yield


@contextlib.contextmanager
def fit_half_batch():
    from repro_torch.gbdt import trainer
    from repro_torch.kernels import ops

    orig = ops.build_histogram

    def half(bins, gh, pos, *, n_nodes, n_bins, method=None):
        pos = pos.clone()
        pos[1::2] = -1
        return orig(bins, gh * 2, pos, n_nodes=n_nodes, n_bins=n_bins, method=method)

    with _patched(ops, "build_histogram", half), _patched(trainer, "build_histogram", half):
        yield


@contextlib.contextmanager
def fit_answer_altered():
    from repro_torch.api.model import ToadModel

    orig = ToadModel.fit_binned

    def altered(self, bins, y, edges):
        out = orig(self, bins, y, edges)
        self.forest = dataclasses.replace(self.forest, leaf_values=self.forest.leaf_values * 1.01)
        return out

    with _patched(ToadModel, "fit_binned", altered):
        yield


def _wrap_predictor(change):
    from repro_torch.api.model import ToadModel

    orig = ToadModel.predictor

    def predictor(self, backend=None):
        return change(orig(self, backend))

    return _patched(ToadModel, "predictor", predictor)


def score_half_batch():
    import torch

    def change(fn):
        def half(x):
            n = x.shape[0]
            part = fn(x[: (n + 1) // 2])
            return torch.cat([part, part], 0)[:n]
        return half

    return _wrap_predictor(change)


def score_answer_altered():
    def change(fn):
        def altered(x):
            out = fn(x)
            out[0, 0] += 0.1
            return out
        return altered

    return _wrap_predictor(change)


@contextlib.contextmanager
def fit_bf16_histograms():
    from repro_torch.api.model import ToadModel

    orig = ToadModel.fit_binned

    def low(self, bins, y, edges):
        self.config = dataclasses.replace(self.config, hist_dtype="bf16")
        return orig(self, bins, y, edges)

    with _patched(ToadModel, "fit_binned", low):
        yield


@contextlib.contextmanager
def score_bf16_reference():
    import torch

    from bench.core import score_loop
    from bench.reference.forest import score_low

    drawn = {}
    make_forest = score_loop.make_forest

    def keep(cfg, seed, pool):
        drawn.update(forest=make_forest(cfg, seed, pool), C=cfg["forest"]["n_ensembles"])
        return drawn["forest"]

    def change(fn):
        return lambda x: score_low(x, drawn["forest"], drawn["C"]).to(torch.float32)

    with _patched(score_loop, "make_forest", keep), _wrap_predictor(change):
        yield


CONTROLS = {"fit_sweep": fit_bf16_histograms, "score_loop": score_bf16_reference}

FAULTS = {
    "fit_sweep": {"state_unchanged": fit_state_unchanged, "half_batch": fit_half_batch,
                  "answer_altered": fit_answer_altered},
    "score_loop": {"half_batch": score_half_batch, "answer_altered": score_answer_altered},
}
