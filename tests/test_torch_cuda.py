"""The CUDA ``packed_predict`` kernel against its plain PyTorch version, on
the card.

Marked ``gpu``; each test decides inside itself whether a Hopper card is
present and skips with the reason otherwise.  JAX is not imported here, so
the file also runs on the machine with the card:

    python -m pytest -q -p no:cacheprovider --noconftest -m gpu tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from chip_smoke import synthetic_forest  # noqa: E402
from repro_torch.core.layout import decode, encode, to_packed  # noqa: E402
from repro_torch.gbdt.forest import forest_from_numpy  # noqa: E402
from repro_torch.kernels.ops import to_device  # noqa: E402
from repro_torch.kernels.predict import packed_predict  # noqa: E402
from repro_torch.kernels.ref import packed_predict_ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a; this card is "
                    f"{torch.cuda.get_device_name(0)}")
    return torch.device("cuda", 0)


def _packed(n_ensembles=1, **kw):
    arrays = synthetic_forest(3, n_ensembles=n_ensembles, **kw)
    forest = forest_from_numpy(arrays, n_ensembles, device="cpu")
    return to_packed(decode(encode(forest))), arrays["edges"]


def _rows(edges, n, seed=0, nan_frac=0.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, size=(n, edges.shape[0])).astype(np.float32)
    x[rng.random(x.shape) < nan_frac] = np.nan
    return x


CASES = {
    "binary-d32-depth6-nan": dict(kw=dict(n_trees=40, max_depth=6, n_features=32,
                                          n_bins=64, n_used_features=12), n=1000,
                                  nan=0.05),
    "multiclass3-T21-depth4": dict(kw=dict(n_trees=21, max_depth=4, n_features=16,
                                           n_bins=32, n_ensembles=3,
                                           n_used_features=6), n=300, nan=0.0),
    "zero-split": dict(kw=dict(n_trees=9, max_depth=3, n_features=8, n_bins=16,
                               n_used_features=0), n=100, nan=0.0),
    "n1": dict(kw=dict(n_trees=12, max_depth=5, n_features=20, n_bins=32,
                       n_used_features=8), n=1, nan=0.0),
    # 64 KB of leaf values: past the 48 KB staging cap, so the kernel reads
    # the small tables from global memory
    "global-tables": dict(kw=dict(n_trees=12, max_depth=5, n_features=20, n_bins=32,
                                  n_used_features=8, n_leaf_values=16_384),
                          n=500, nan=0.05),
    "n257": dict(kw=dict(n_trees=12, max_depth=5, n_features=20, n_bins=32,
                         n_used_features=8), n=257, nan=0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version_to_the_bit(card, case):
    spec = CASES[case]
    kw = dict(spec["kw"])
    C = kw.pop("n_ensembles", 1)
    packed, edges = _packed(C, **kw)
    dev = to_device(packed, card)
    x = torch.from_numpy(_rows(edges, spec["n"], nan_frac=spec["nan"])).to(card)
    before = packed_predict.launches
    got = packed_predict(x, *dev.arrays(), **dev.meta())
    want = packed_predict_ref(x, *dev.arrays(), **dev.meta())
    torch.cuda.synchronize()
    assert packed_predict.launches == before + 1
    assert got.shape == (spec["n"], C)
    # same per-column summation order: equal to the bit
    assert torch.equal(got, want), (got - want).abs().max().item()


def test_zero_tree_model_returns_base_without_launch(card):
    packed, edges = _packed(1, n_trees=0, max_depth=3, n_features=8, n_bins=16,
                            n_used_features=4)
    dev = to_device(packed, card)
    x = torch.from_numpy(_rows(edges, 10)).to(card)
    before = packed_predict.launches
    got = packed_predict(x, *dev.arrays(), **dev.meta())
    assert packed_predict.launches == before
    assert torch.equal(got, dev.base_score[None, :].expand(10, 1))


def test_wrapper_refuses_a_feature_past_x(card):
    packed, edges = _packed(1, n_trees=4, max_depth=3, n_features=8, n_bins=16,
                            n_used_features=4)
    dev = to_device(packed, card)
    x = torch.zeros((4, int(packed.used_features.max())), device=card)
    with pytest.raises(ValueError, match="feature"):
        packed_predict(x, *dev.arrays(), **dev.meta())
