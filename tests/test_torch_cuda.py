"""The CUDA kernels (``packed_predict``, ``histogram``,
``packed_predict_early_exit``, ``binning``) against their plain PyTorch
versions, training on the card against training on the CPU, and
compression on the card against compression on the CPU.

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

from chip_smoke import (  # noqa: E402
    BINNING_CASES,
    _ee_plain,
    binning_inputs,
    early_exit_forest,
    synthetic_forest,
)
from repro_torch.api import ToadModel  # noqa: E402
from repro_torch.core.treeorder import remaining_mass  # noqa: E402
from repro_torch.core.layout import decode, encode, to_packed  # noqa: E402
from repro_torch.gbdt import GBDTConfig, apply_bins, fit_bins, train  # noqa: E402
from repro_torch.gbdt.forest import forest_from_numpy  # noqa: E402
from repro_torch.kernels.binning import binning  # noqa: E402
from repro_torch.kernels.histogram import histogram  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    apply_binning,
    build_histogram,
    sibling_subtraction_histograms,
    to_device,
)
from repro_torch.kernels.predict import (  # noqa: E402
    device_exit_tables,
    packed_predict,
    packed_predict_early_exit,
    tree_block_for,
)
from repro_torch.kernels.ref import (  # noqa: E402
    binning_ref,
    histogram_ref,
    packed_predict_ref,
)

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


HIST_CASES = {
    # name: (n, d, n_bins, n_nodes, CH, bins dtype, column-major)
    "root-d33-256bins-u8-col": (5000, 33, 256, 1, 3, torch.uint8, True),
    "9-nodes-i32-row": (5000, 7, 64, 9, 3, torch.int32, False),
    "64-nodes-CH2-u8-row": (20000, 5, 256, 64, 2, torch.uint8, False),
    "n1": (1, 4, 16, 2, 3, torch.uint8, True),
    "n511": (511, 3, 16, 3, 3, torch.uint8, True),
    "n513-d1": (513, 1, 256, 5, 3, torch.int32, True),
}


def _hist_inputs(card, n, d, n_bins, n_nodes, CH, dtype, col, seed=0):
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, n_bins, (n, d))).to(card, dtype)
    if col:
        bins = bins.t().contiguous().t()
    gh = torch.from_numpy(np.stack(
        [rng.normal(size=n), rng.uniform(0.1, 1.0, n), np.ones(n)], -1)[:, :CH]
        .astype(np.float32)).to(card)
    pos = rng.integers(0, max(n_nodes - 1, 1), n)  # last node empty
    pos[rng.random(n) < 0.05] = n_nodes  # out of range: dropped
    pos[rng.random(n) < 0.05] = -1
    return bins, gh, torch.from_numpy(pos.astype(np.int32)).to(card)


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_histogram_kernel_matches_plain_version_and_repeats_to_the_bit(card, case):
    n, d, n_bins, n_nodes, CH, dtype, col = HIST_CASES[case]
    bins, gh, pos = _hist_inputs(card, n, d, n_bins, n_nodes, CH, dtype, col)
    before = histogram.launches
    got = histogram(bins, gh, pos, n_nodes=n_nodes, n_bins=n_bins)
    again = histogram(bins, gh, pos, n_nodes=n_nodes, n_bins=n_bins)
    # the plain version sums in float64 here: in float32 on the card it adds
    # with float atomics, whose own error grows with the rows a cell sums
    want = histogram_ref(bins, gh.double(), pos, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert histogram.launches == before + 2
    assert got.shape == (n_nodes, d, n_bins, CH)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    if CH == 3:
        assert torch.equal(got[..., 2].double(), want[..., 2])  # counts exact
    assert torch.equal(got, again)  # int64 fixed point: order-free sums
    if n_nodes > 1:
        assert not got[n_nodes - 1].any()


def test_histogram_kernel_bf16_channels_and_sibling_subtraction(card):
    bins, gh, pos = _hist_inputs(card, 4000, 6, 32, 8, 3, torch.uint8, True, seed=3)
    pos = pos.clamp(0, 7)
    gh16 = gh.to(torch.bfloat16)
    got = build_histogram(bins, gh16, pos, n_nodes=8, n_bins=32, method="cuda")
    want = histogram_ref(bins, gh16.double(), pos, 8, 32)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    parent = torch.div(pos, 2, rounding_mode="floor")
    parent_hist = build_histogram(bins, gh, parent, n_nodes=4, n_bins=32, method="cuda")
    sub = sibling_subtraction_histograms(bins, gh, pos, parent_hist, n_bins=32, method="cuda")
    direct = build_histogram(bins, gh, pos, n_nodes=8, n_bins=32, method="cuda")
    torch.testing.assert_close(sub, direct, rtol=1e-5, atol=1e-5)


def test_trees_on_the_card_equal_trees_on_the_cpu(card):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(6000, 24)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + 0.3 * X[:, 2] ** 2 > 0).astype(np.float32)
    edges = fit_bins(X, 64)
    cfg = GBDTConfig(task="binary", n_rounds=3, max_depth=5, learning_rate=0.1,
                     toad_penalty_feature=8.0, toad_penalty_threshold=2.0)
    out = {}
    for dev in ("cpu", card):
        e = torch.from_numpy(edges).to(dev)
        bins = apply_bins(torch.from_numpy(X).to(dev), e)
        before = histogram.launches
        out[str(dev)] = train(cfg, bins, torch.from_numpy(y).to(dev), e)[0]
        if dev == card:
            # 5 levels + the leaf statistics per tree, 3 trees
            assert histogram.launches - before == 18
    cpu, gpu = out["cpu"], out[str(card)]
    for k in ("feature", "thr_bin", "is_split", "leaf_ref", "n_trees", "n_leaf_values"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k
    torch.testing.assert_close(gpu.leaf_values.cpu(), cpu.leaf_values, rtol=1e-4, atol=1e-5)


EE_CASES = {
    # name: (early_exit_forest kwargs, n, NaN share, slack, min_trees, base shift)
    "T5": (dict(n_trees=5), 1000, 0.0, 0.0, 0, 0.0),
    "T8": (dict(n_trees=8), 1000, 0.0, 0.0, 0, 0.0),
    "T12": (dict(n_trees=12), 1000, 0.0, 0.0, 0, 0.0),
    "all-exit-block-0": (dict(n_trees=20), 1000, 0.0, 0.0, 0, 10.0),
    "no-exit": (dict(n_trees=20), 1000, 0.0, 1e9, 0, 0.0),
    "min-trees-9": (dict(n_trees=20), 1000, 0.0, 0.0, 9, 10.0),
    "multiclass3-T21-nan": (dict(n_trees=21, n_ensembles=3), 1000, 0.05, 0.0, 0, 0.0),
    "zero-split": (dict(n_trees=20, n_used_features=0), 300, 0.0, 0.0, 0, 0.0),
    # 64 depth-8 trees over their own leaves: 64 KB of leaf values, read from
    # global memory
    "global-tables": (dict(n_trees=64, max_depth=8), 1000, 0.05, 0.0, 0, 0.0),
    "n1": (dict(n_trees=20), 1, 0.0, 0.0, 0, 0.0),
    "n255": (dict(n_trees=20), 255, 0.0, 0.0, 0, 0.0),
    "n257": (dict(n_trees=20), 257, 0.0, 0.0, 0, 0.0),
}


@pytest.mark.parametrize("case", sorted(EE_CASES))
def test_early_exit_kernel_matches_plain_version_to_the_bit(card, case):
    spec, n, nan, slack, min_trees, shift = EE_CASES[case]
    kw = dict(max_depth=6, n_features=32, n_bins=64, n_used_features=12)
    kw.update(spec)
    C = kw.get("n_ensembles", 1)
    arrays = early_exit_forest(7, **kw)
    arrays["base_score"] = arrays["base_score"] + np.float32(shift)
    forest = forest_from_numpy(arrays, C, device="cpu")
    dev = to_device(to_packed(decode(encode(forest))), card)
    bound = remaining_mass(forest)
    x = torch.from_numpy(_rows(arrays["edges"], n, nan_frac=nan)).to(card)
    T = dev.words.shape[0]
    tables = device_exit_tables(bound, np.full(C, slack), n_trees=T, n_ensembles=C,
                                min_trees=min_trees, device=card)
    before = packed_predict_early_exit.launches
    got = packed_predict_early_exit(x, *dev.arrays(), bound, np.full(C, slack),
                                    **dev.meta(), guard=1e-4, min_trees=min_trees)
    again = packed_predict_early_exit(x, *dev.arrays(), **dev.meta(), guard=1e-4,
                                      tables=tables)
    want = _ee_plain(x, dev, tables, 1e-4)
    torch.cuda.synchronize()
    assert packed_predict_early_exit.launches == before + 2
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    trees, exited = got[1], got[2]
    tb = tree_block_for(C)
    assert bool((trees[exited] % tb == 0).all()) and bool((trees[~exited] == T).all())
    if case == "all-exit-block-0":
        assert bool(exited.all()) and bool((trees == 8).all())
    if case == "no-exit":
        assert not bool(exited.any())
    if case == "min-trees-9":
        assert bool((trees == 16).all())


def test_early_exit_zero_tree_model_returns_base_without_launch(card):
    arrays = synthetic_forest(3, n_trees=0, max_depth=3, n_features=8, n_bins=16,
                              n_used_features=4)
    forest = forest_from_numpy(arrays, 1, device="cpu")
    dev = to_device(to_packed(decode(encode(forest))), card)
    x = torch.from_numpy(_rows(arrays["edges"], 10)).to(card)
    before = packed_predict_early_exit.launches
    s, t, e = packed_predict_early_exit(x, *dev.arrays(), remaining_mass(forest), [0.0],
                                        **dev.meta())
    assert packed_predict_early_exit.launches == before
    assert torch.equal(s, dev.base_score[None, :].expand(10, 1))
    assert not t.any() and not e.any()


@pytest.mark.parametrize("case", range(len(BINNING_CASES)),
                         ids=[f"n{n}-d{d}-E{E}" for n, d, E in BINNING_CASES])
def test_binning_kernel_matches_plain_version(card, case):
    """chip_smoke's cases: +inf tails, an all-+inf feature, on-edge ±1 ulp,
    NaN and ±inf, the staged and the global-memory edge variants; equal
    element by element, two runs equal, and through ``apply_binning`` equal
    to ``apply_bins``."""
    n, d, E = BINNING_CASES[case]
    x, edges = binning_inputs(n, d, E, seed=100 + case)
    xt, et = torch.from_numpy(x).to(card), torch.from_numpy(edges).to(card)
    before = binning.launches
    got, again = binning(xt, et), apply_binning(xt, et, device=card)
    torch.cuda.synchronize()
    assert binning.launches == before + 2
    assert got.dtype == torch.int32 and got.shape == (n, d)
    assert torch.equal(got, binning_ref(xt, et)) and torch.equal(got, again)
    assert torch.equal(got, apply_bins(xt, et))


def test_binning_without_edges_does_not_launch(card):
    before = binning.launches
    out = binning(torch.zeros((10, 3), device=card), torch.zeros((3, 0), device=card))
    assert binning.launches == before and not out.any() and out.shape == (10, 3)


def test_compress_on_the_card_gives_the_cpu_stream(card):
    """The budget ladder (codebooks made on the host) compresses a forest on
    the card to the stream it gives on the CPU, and toadcheck passes it."""
    arrays = synthetic_forest(4, n_trees=24, max_depth=6, n_features=32, n_bins=64,
                              n_used_features=16, n_leaf_values=1024)
    cfg = GBDTConfig(task="binary", n_rounds=24, max_depth=6)
    models = {}
    for dev in ("cpu", card):
        forest = forest_from_numpy(arrays, 1, device=dev)
        models[str(dev)] = ToadModel.from_forest(forest, cfg, n_bins=64, device=dev)
    budget = models["cpu"].memory_report()["toad_bytes"] / 2
    for m in models.values():
        m.compress(budget_bytes=budget)
    cpu, gpu = models["cpu"], models[str(card)]
    assert gpu.spec == cpu.spec and gpu.spec.name != "exact"
    assert gpu.encoded.n_bits == cpu.encoded.n_bits
    np.testing.assert_array_equal(gpu.encoded.data, cpu.encoded.data)
    assert gpu.forest.edges.device == card
    assert gpu.verify() == []
