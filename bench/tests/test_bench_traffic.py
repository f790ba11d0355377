"""The traffic and the inputs: the same seed gives the same work, and every
seed scores the same sizes."""

import numpy as np
import pytest
import torch
from bench_small import CELLS

from bench.core import score_loop, seeds, spec
from bench.inputs import covtype, gaussian_rule3

SEED = 2**31 + 12345


def test_sub_seeds_are_stable_and_distinct():
    assert seeds.sub_seed(SEED, 1, 0) == seeds.sub_seed(SEED, 1, 0)
    assert seeds.sub_seed(SEED, 1, 0) != seeds.sub_seed(SEED, 1, 1)
    assert seeds.sub_seed(SEED, 1, 0) != seeds.sub_seed(SEED + 1, 1, 0)
    assert 0 <= seeds.sub_seed(2**40 + 3, 2) < 2**63


@pytest.mark.parametrize("kind,d", [("gaussian_rule3", 8), ("covtype", 54)])
def test_rows_per_seed(kind, d):
    draw = spec.input_kind({"inputs": {"kind": kind}}).draw
    a, ya = draw(SEED, 0, 512, d, "cpu", labels=True)
    b, yb = draw(SEED, 0, 512, d, "cpu", labels=True)
    c, _ = draw(SEED + 1, 0, 512, d, "cpu")
    e, _ = draw(SEED, 1, 512, d, "cpu")
    assert a.shape == (512, d) and torch.equal(a, b) and torch.equal(ya, yb)
    assert not torch.equal(a, c) and not torch.equal(a, e)
    assert ya.shape == (512,) and ya.dtype == torch.float32
    assert torch.equal(draw(SEED, 0, 512, d, "cpu")[0], a)  # labels draw nothing from x's stream


def test_covtype_shape_and_classes():
    x, y = covtype.draw(SEED, 0, 4096, 54, "cpu", labels=True)
    assert torch.equal(x[:, 10:14].sum(1), torch.ones(4096))  # one wilderness area
    assert torch.equal(x[:, 14:].sum(1), torch.ones(4096))  # one soil type
    assert float(x[:, 1].min()) >= 0 and abs(float(x[:, 0].mean()) - 2800) < 200
    counts = torch.bincount(y.long(), minlength=7).tolist()
    # cut at the quantiles .2 .45 .6 .75 .85 .95 of the chunk's terrain score
    want = [0.2, 0.25, 0.15, 0.15, 0.10, 0.10, 0.05]
    assert len(counts) == 7 and all(abs(c / 4096 - w) < 2e-3 for c, w in zip(counts, want))


def test_rule3_labels():
    x = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 1.0, 2.0]])
    assert gaussian_rule3.rule3_labels(x).tolist() == [1.0, 0.0, 1.0]


@pytest.mark.parametrize("name", ["covtype_multi-score", "toad_gbdt-score"])
def test_score_plan_per_seed(name):
    cell = spec.cell(name, CELLS[name])
    a = score_loop.setup(cell, SEED, "cpu")
    b = score_loop.setup(cell, SEED, "cpu")
    c = score_loop.setup(cell, SEED + 1, "cpu")
    assert np.array_equal(a["plan_n"], b["plan_n"]) and np.array_equal(a["plan_off"], b["plan_off"])
    assert not np.array_equal(a["plan_n"], c["plan_n"])
    K = len(a["sizes"])
    assert sorted(a["plan_n"][:K]) == sorted(c["plan_n"][:K]) == list(a["sizes"])
    assert (a["plan_off"] + a["plan_n"] <= cell["traffic"]["pool_rows"]).all()
    assert torch.equal(a["pool"], b["pool"])


def test_request_sizes_are_log_spaced():
    sizes = score_loop.request_sizes({"min_rows": 16384, "max_rows": 1048576, "sizes": 32})
    assert sizes[0] == 16384 and sizes[-1] == 1048576 and len(sizes) == 32
    ratios = sizes[1:] / sizes[:-1]
    assert np.allclose(ratios, ratios.mean(), rtol=1e-3)


def test_fit_order_per_seed():
    pens = spec.cell("toad_gbdt-fit")["traffic"]["penalties"]
    a = seeds.permutation(SEED, seeds.ORDER, len(pens))
    assert np.array_equal(a, seeds.permutation(SEED, seeds.ORDER, len(pens)))
    assert sorted(a) == list(range(len(pens)))
