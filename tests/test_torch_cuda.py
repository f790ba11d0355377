"""The CUDA kernels (``packed_predict``, ``histogram``,
``packed_predict_early_exit``, ``binning``, ``commit_level``) against their
plain PyTorch versions, training on the card against training on the CPU, data-parallel
training on the card against one process, compression on the card
against compression on the CPU, and the reduced qwen3-4b, olmoe-1b-7b,
rwkv6-1.6b, recurrentgemma-9b and whisper-small LM serving path on the
card against the CPU's, the 10 reduced LM configs' training step
(loss, gradients, one optimizer update) on the card against the CPU's,
the dry run's meta trace of two full-width LM steps against the card, and
the reduced transformer, rwkv6, recurrentgemma and whisper configs served
on a (data, model) mesh of 4 gloo ranks sharing the card against the same
ranks on the CPU.

Marked ``gpu``; each test decides inside itself whether a Hopper card is
present and skips with the reason otherwise.  JAX is not imported here, so
the file also runs on the machine with the card:

    python -m pytest -q -p no:cacheprovider --noconftest -m gpu tests/test_torch_cuda.py
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from chip_smoke import (  # noqa: E402
    BINNING_CASES,
    COMMIT_CASES,
    DRYRUN_CASES,
    LM_ARGMAX,
    LM_MESH_REDUCED,
    _ee_plain,
    binning_inputs,
    bits_equal,
    commit_inputs,
    dryrun_check,
    early_exit_forest,
    lm_card_equals_cpu,
    lm_mesh_card_equals_cpu,
    lm_train_card_equals_cpu,
    plan_of,
    run_commit,
    synthetic_forest,
)
from repro_torch.api import ToadModel  # noqa: E402
from repro_torch.core.treeorder import remaining_mass  # noqa: E402
from repro_torch.core.layout import decode, encode, to_packed  # noqa: E402
from repro_torch.gbdt import GBDTConfig, apply_bins, fit_bins, train  # noqa: E402
from repro_torch.gbdt.distributed import spawn_data_parallel  # noqa: E402
from repro_torch.gbdt.forest import forest_from_numpy  # noqa: E402
from repro_torch.kernels.binning import binning  # noqa: E402
from repro_torch.kernels.commit import commit_level, commit_level_ref  # noqa: E402
from repro_torch.kernels.histogram import histogram  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    apply_binning,
    build_histogram,
    sibling_subtraction_histograms,
    to_device,
)
from repro_torch.kernels.predict import (  # noqa: E402
    STAGE_TREES,
    STAGE_X,
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


def _pad_tables(dev, n_thr=0, n_lv=0):
    """``dev`` with ``n_thr`` thresholds and ``n_lv`` leaf values appended that
    no word references: large tables, and no score changes."""
    return dataclasses.replace(
        dev, thr_table=torch.cat([dev.thr_table, dev.thr_table.new_zeros(n_thr)]),
        leaf_values=torch.cat([dev.leaf_values, dev.leaf_values.new_zeros(n_lv)]))


def _check_plan(dev, n, expect, early_exit=False):
    """The plan the wrapper takes for these shapes, held to ``expect``:
    (split, rows, stage bits it has, stage bits it lacks)."""
    plan = plan_of(dev, n, early_exit)
    split, rows, has, lacks = expect
    assert (plan.split, plan.rows) == (split, rows), plan.describe()
    assert plan.stage & has == has and not plan.stage & lacks, plan.describe()
    return plan


X, TR = STAGE_X, STAGE_TREES
D6 = dict(n_trees=40, max_depth=6, n_features=32, n_bins=64, n_used_features=12)
D5 = dict(n_trees=12, max_depth=5, n_features=20, n_bins=32, n_used_features=8)
# name: (synthetic_forest kwargs, n, NaN share, (thresholds, leaf values)
# padded on by ``_pad_tables``, the plan's (split, rows, stage bits it has,
# stage bits it lacks)); the cases launch every variant of the kernel: split
# and unsplit grids (32- and 128-row tiles, groups of several tree blocks), T
# below and off a multiple of tree_block, C = 3 (tree_block 9: the words of
# blocks 1, 2, ... start off a 16-byte boundary), x and the trees each staged
# and read from global memory, large threshold and leaf tables
CASES = {
    "binary-d32-depth6-nan": (D6, 1000, 0.05, None, (True, 32, X | TR, 0)),
    "multiclass3-T21-depth4": (dict(n_trees=21, max_depth=4, n_features=16, n_bins=32,
                                    n_ensembles=3, n_used_features=6), 300, 0.0, None,
                               (True, 32, X | TR, 0)),
    "zero-split": (dict(n_trees=9, max_depth=3, n_features=8, n_bins=16,
                        n_used_features=0), 100, 0.0, None, (True, 32, X | TR, 0)),
    "n1": (D5, 1, 0.0, None, (True, 32, X | TR, 0)),
    # 64 KB of leaf values: a staged tree block resolves its own through leaf_ref
    "global-tables": (dict(D5, n_leaf_values=16_384), 500, 0.05, None,
                      (True, 32, X | TR, 0)),
    "n257": (D5, 257, 0.0, None, (True, 32, X | TR, 0)),
    **{f"split-n{n}": (D6, n, 0.0, None, (True, 32, X | TR, 0)) for n in (31, 32, 33, 256)},
    "split-n4096-several-tree-blocks-a-group": (dict(D6, n_trees=100), 4096, 0.01, None,
                                                (True, 32, X | TR, 0)),
    "unsplit-32-row-tiles-n16384": (D6, 16_384, 0.01, None, (False, 32, X | TR, 0)),
    "unsplit-128-row-tiles-n40000-nan": (D6, 40_000, 0.05, None,
                                         (False, 128, X | TR, 0)),
    "T5-one-tree-block": (dict(D6, n_trees=5), 1000, 0.0, None, (False, 32, X | TR, 0)),
    "T21-ragged-tree-block": (dict(D6, n_trees=21), 1000, 0.0, None,
                              (True, 32, X | TR, 0)),
    "C3-tree-block-9-unsplit-n40000": (dict(D6, n_trees=27, n_ensembles=3), 40_000, 0.01,
                                       None, (False, 128, X | TR, 0)),
    "depth10-words-global": (dict(D6, n_trees=12, max_depth=10), 2000, 0.01, None,
                             (True, 32, X, TR)),
    "n_fu300-x-global": (dict(n_trees=64, max_depth=8, n_features=320, n_bins=64,
                              n_used_features=300), 3000, 0.01, None,
                         (True, 32, TR, X)),
    "13000-thresholds": (D6, 2000, 0.01, (13_000, 0), (True, 32, X | TR, 0)),
    "16384-leaf-values-unsplit-n40000": (D6, 40_000, 0.01, (0, 16_384),
                                         (False, 128, X | TR, 0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version_to_the_bit(card, case):
    kw, n, nan, pad, expect = CASES[case]
    kw = dict(kw)
    C = kw.pop("n_ensembles", 1)
    packed, edges = _packed(C, **kw)
    dev = to_device(packed, card)
    if pad:
        dev = _pad_tables(dev, *pad)
    plan = _check_plan(dev, n, expect)
    if "several-tree-blocks" in case:
        assert plan.per_group > 1
    x = torch.from_numpy(_rows(edges, n, nan_frac=nan)).to(card)
    before = packed_predict.launches
    got = packed_predict(x, *dev.arrays(), **dev.meta())
    again = packed_predict(x, *dev.arrays(), **dev.meta())
    want = packed_predict_ref(x, *dev.arrays(), **dev.meta())
    torch.cuda.synchronize()
    assert packed_predict.launches == before + 2  # one a call, split or not
    assert got.shape == (n, C)
    # the plain version's block order: equal to the bit, every run
    assert torch.equal(got, want), (got - want).abs().max().item()
    assert torch.equal(got, again)


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
    # name: (n, d, n_bins, n_nodes, CH, bins dtype, layout, nodes the rows use)
    #   layout: "col" column-major, "row" row-major (the trainer's), "slice"
    #   the first d features of a row-major (n, 48) tensor; nodes: None =
    #   every node but the last, with 5% of the rows out of range each side
    "root-d33-256bins-u8-col": (5000, 33, 256, 1, 3, torch.uint8, "col", None),
    "9-nodes-i32-row": (5000, 7, 64, 9, 3, torch.int32, "row", None),
    "64-nodes-CH2-u8-row": (20000, 5, 256, 64, 2, torch.uint8, "row", None),
    "n1": (1, 4, 16, 2, 3, torch.uint8, "col", None),
    "n511": (511, 3, 16, 3, 3, torch.uint8, "col", None),
    "n513-d1": (513, 1, 256, 5, 3, torch.int32, "col", None),
    "64-nodes-256bins-d64-row": (40000, 64, 256, 64, 3, torch.uint8, "row", None),
    "128-nodes-256bins-d32-row": (40000, 32, 256, 128, 3, torch.uint8, "row", None),
    "one-node-all-rows-d48-row": (30000, 48, 256, 1, 3, torch.uint8, "row", (0,)),
    "empty-nodes-16-row": (20000, 32, 256, 16, 3, torch.uint8, "row", (0, 5, 9, 15)),
    "d33-slice-of-48": (20000, 33, 256, 6, 3, torch.uint8, "slice", None),
    "leaf-1bin-256-nodes": (30000, 1, 1, 256, 3, torch.uint8, "row", tuple(range(256))),
    "i32-512bins-row": (5000, 20, 512, 5, 3, torch.int32, "row", None),
    "CH5-d16-row": (6000, 16, 32, 3, 5, torch.uint8, "row", None),
    # past the sort's shared-memory counters (4,096 nodes) and the one-bin
    # kernel's shared cells (2,048 nodes at d = 1, CH = 3): global atomics
    "5000-nodes-16bins": (30000, 3, 16, 5000, 3, torch.uint8, "row", None),
    "leaf-1bin-4096-nodes": (30000, 1, 1, 4096, 3, torch.uint8, "row", None),
}


def _hist_inputs(card, n, d, n_bins, n_nodes, CH, dtype, layout, nodes=None, seed=0):
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, n_bins, (n, 48 if layout == "slice" else d)))
    bins = bins.to(card, dtype)
    if layout == "col":
        bins = bins.t().contiguous().t()
    elif layout == "slice":
        bins = bins[:, :d]
    gh = torch.from_numpy(np.stack(
        [rng.normal(size=n), rng.uniform(0.1, 1.0, n), np.ones(n)]
        + [rng.normal(size=n) for _ in range(CH - 3)], -1)[:, :CH]
        .astype(np.float32)).to(card)
    if nodes is None:
        pos = rng.integers(0, max(n_nodes - 1, 1), n)  # last node empty
        pos[rng.random(n) < 0.05] = n_nodes  # out of range: dropped
        pos[rng.random(n) < 0.05] = -1
    else:
        pos = rng.choice(np.asarray(nodes), n)
    return bins, gh, torch.from_numpy(pos.astype(np.int32)).to(card)


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_histogram_kernel_matches_plain_version_and_repeats_to_the_bit(card, case):
    n, d, n_bins, n_nodes, CH, dtype, layout, nodes = HIST_CASES[case]
    bins, gh, pos = _hist_inputs(card, n, d, n_bins, n_nodes, CH, dtype, layout, nodes)
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
    if CH >= 3:
        assert torch.equal(got[..., 2].double(), want[..., 2])  # counts exact
    assert torch.equal(got, again)  # int64 fixed point: order-free sums
    used = set(range(max(n_nodes - 1, 1))) if nodes is None else set(nodes)
    for empty in set(range(n_nodes)) - used:
        assert not got[empty].any()


@pytest.mark.parametrize("levels", [(1, 256), (64, 256), (16, 64)])
def test_histogram_dropped_rows_give_the_bits_of_zeroed_rows(card, levels):
    """The trainer's sibling-subtraction call passes right rows with pos = -1;
    zeroing their channels instead gives the same cells, the same bits (the
    channel maxima come from the rows that count in both)."""
    n_parents, n_bins = levels
    bins, gh, _ = _hist_inputs(card, 30000, 32, n_bins, 1, 3, torch.uint8, "row", seed=4)
    rng = np.random.default_rng(6)
    child = torch.from_numpy(rng.integers(0, 2 * n_parents, 30000).astype(np.int32)).to(card)
    left = child % 2 == 0
    parent = torch.div(child, 2, rounding_mode="floor")
    zeroed = histogram(bins, torch.where(left[:, None], gh, 0.0), parent,
                       n_nodes=n_parents, n_bins=n_bins)
    dropped = histogram(bins, gh, torch.where(left, parent, -1),
                        n_nodes=n_parents, n_bins=n_bins)
    assert torch.equal(zeroed, dropped)


def test_histogram_kernel_bf16_channels_and_sibling_subtraction(card):
    bins, gh, pos = _hist_inputs(card, 4000, 6, 32, 8, 3, torch.uint8, "col", seed=3)
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
        commits = commit_level.launches
        out[str(dev)] = train(cfg, bins, torch.from_numpy(y).to(dev), e)[0]
        if dev == card:
            # 5 levels + the leaf statistics per tree, 3 trees
            assert histogram.launches - before == 18
            # one commit a level: 5 levels x 3 trees
            assert commit_level.launches - commits == 15
        else:
            assert commit_level.launches == commits
    cpu, gpu = out["cpu"], out[str(card)]
    for k in ("feature", "thr_bin", "is_split", "leaf_ref", "n_trees", "n_leaf_values"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k
    torch.testing.assert_close(gpu.leaf_values.cpu(), cpu.leaf_values, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", sorted(COMMIT_CASES))
def test_commit_kernel_equals_plain_version_to_the_bit(card, case):
    """One level's commit on the card: the kernel against the plain loop on
    the same card tensors, every output equal to the bit (the used sets,
    the tree's four arrays, the split count), one launch a call."""
    ins, scalars, outs = commit_inputs(card, **COMMIT_CASES[case])
    want = run_commit(commit_level_ref, ins, scalars, outs)
    before = commit_level.launches
    got = run_commit(commit_level, ins, scalars, outs)
    torch.cuda.synchronize()
    assert commit_level.launches == before + 1
    for k in outs:
        assert bits_equal(got[k], want[k]), k
    assert int(want["n_splits"]) > int(outs["n_splits"])  # the level commits


def test_data_parallel_on_the_card_grows_the_single_process_trees(card):
    """4 ranks on the card (gloo; one card shared, or NCCL with a card each),
    every rank's histograms through the kernel, the trees equal to the
    single-process card fit; leaf values within 2e-5 (each rank's sums are
    exact fixed point, then four float32 sums are added)."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(16384, 24)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + 0.3 * X[:, 2] ** 2 > 0).astype(np.float32)
    e = torch.from_numpy(fit_bins(X, 64)).to(card)
    bins = apply_bins(torch.from_numpy(X).to(card), e)
    cfg = GBDTConfig(task="binary", n_rounds=3, max_depth=5, learning_rate=0.1,
                     toad_penalty_feature=8.0, toad_penalty_threshold=2.0)
    one, _, aux = train(cfg, bins, torch.from_numpy(y).to(card), e)
    dp, _, dp_aux = spawn_data_parallel(cfg, bins, y, e, world_size=4, device=card)
    # 5 levels + the leaf statistics a tree, 3 trees, on every rank
    assert dp_aux["rank_histogram_launches"] == [18] * 4
    for k in ("feature", "thr_bin", "is_split", "leaf_ref", "n_trees", "n_leaf_values"):
        assert torch.equal(getattr(dp, k), getattr(one, k)), k
    torch.testing.assert_close(dp.leaf_values, one.leaf_values, rtol=0, atol=2e-5)
    torch.testing.assert_close(dp_aux["preds"], aux["preds"], rtol=0, atol=2e-5)


EE_D6 = dict(n_trees=20, max_depth=6, n_features=32, n_bins=64, n_used_features=12)
EE_CASES = {
    # name: (early_exit_forest kwargs, n, NaN share, slack, min_trees, base
    #   shift, (thresholds, leaf values) padded on, the plan's (split, rows,
    #   stage bits it has, stage bits it lacks))
    "T5": (dict(n_trees=5), 1000, 0.0, 0.0, 0, 0.0, None, (False, 32, X | TR, 0)),
    "T8": (dict(n_trees=8), 1000, 0.0, 0.0, 0, 0.0, None, (False, 32, X | TR, 0)),
    "T12": (dict(n_trees=12), 1000, 0.0, 0.0, 0, 0.0, None, (False, 32, X | TR, 0)),
    "all-exit-block-0": (dict(n_trees=20), 1000, 0.0, 0.0, 0, 10.0, None,
                         (False, 32, X | TR, 0)),
    "no-exit": (dict(n_trees=20), 1000, 0.0, 1e9, 0, 0.0, None, (False, 32, X | TR, 0)),
    "min-trees-9": (dict(n_trees=20), 1000, 0.0, 0.0, 9, 10.0, None,
                    (False, 32, X | TR, 0)),
    "multiclass3-T21-nan": (dict(n_trees=21, n_ensembles=3), 1000, 0.05, 0.0, 0, 0.0, None,
                            (False, 32, X | TR, 0)),
    "zero-split": (dict(n_trees=20, n_used_features=0), 300, 0.0, 0.0, 0, 0.0, None,
                   (False, 32, X | TR, 0)),
    # 64 depth-8 trees over their own leaves: 64 KB of leaf values
    "global-tables": (dict(n_trees=64, max_depth=8), 1000, 0.05, 0.0, 0, 0.0, None,
                      (False, 32, X | TR, 0)),
    "n1": (dict(n_trees=20), 1, 0.0, 0.0, 0, 0.0, None, (False, 32, X | TR, 0)),
    "n255": (dict(n_trees=20), 255, 0.0, 0.0, 0, 0.0, None, (False, 32, X | TR, 0)),
    "n257": (dict(n_trees=20), 257, 0.0, 0.0, 0, 0.0, None, (False, 32, X | TR, 0)),
    "mixed-128-row-tiles-n40000": (EE_D6, 40_000, 0.01, 0.0, 0, 0.0, None,
                                   (False, 128, X | TR, 0)),
    "C3-tree-block-9-n40000": (dict(EE_D6, n_trees=27, n_ensembles=3), 40_000, 0.01, 0.0, 0,
                               0.0, None, (False, 128, X | TR, 0)),
    "depth10-words-global": (dict(EE_D6, max_depth=10), 1000, 0.01, 0.0, 0, 0.0, None,
                             (False, 32, X, TR)),
    "n_fu300-x-global": (dict(n_trees=24, max_depth=8, n_features=320, n_bins=64,
                              n_used_features=300), 2000, 0.01, 0.0, 0, 0.0, None,
                         (False, 32, TR, X)),
    "13000-thresholds": (EE_D6, 2000, 0.01, 0.0, 0, 0.0, (13_000, 0), (False, 32, X | TR, 0)),
}


@pytest.mark.parametrize("case", sorted(EE_CASES))
def test_early_exit_kernel_matches_plain_version_to_the_bit(card, case):
    spec, n, nan, slack, min_trees, shift, pad, expect = EE_CASES[case]
    kw = dict(max_depth=6, n_features=32, n_bins=64, n_used_features=12)
    kw.update(spec)
    C = kw.get("n_ensembles", 1)
    arrays = early_exit_forest(7, **kw)
    arrays["base_score"] = arrays["base_score"] + np.float32(shift)
    forest = forest_from_numpy(arrays, C, device="cpu")
    dev = to_device(to_packed(decode(encode(forest))), card)
    if pad:
        dev = _pad_tables(dev, *pad)
    _check_plan(dev, n, expect, early_exit=True)
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
    # rows that did not exit: B1's scores (both sum in the block order), to the bit
    full = packed_predict(x, *dev.arrays(), **dev.meta())
    assert torch.equal(got[0][~exited], full[~exited])
    if case == "all-exit-block-0":
        assert bool(exited.all()) and bool((trees == 8).all())
    if case == "no-exit":
        assert not bool(exited.any())
    if case == "min-trees-9":
        assert bool((trees == 16).all())
    if case in ("T12", "mixed-128-row-tiles-n40000", "C3-tree-block-9-n40000"):
        assert bool(exited.any()) and not bool(exited.all())


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


@pytest.mark.parametrize("d,flat", [(9, False), (8, True), (6, False)])
def test_binning_kernel_on_a_misaligned_x(card, d, flat):
    """x one row into a larger tensor (d odd: 36 bytes in), or one element
    into a flat one (d = 8: 4 bytes in): contiguous but not 16-byte
    aligned, so the kernel takes its scalar loads."""
    n, E = 700, 255
    x, edges = binning_inputs(n + 1, d, E, seed=7 + d)
    big, et = torch.from_numpy(x).to(card), torch.from_numpy(edges).to(card)
    xt = big.view(-1)[1:1 + n * d].view(n, d) if flat else big[1:]
    assert xt.is_contiguous() and xt.data_ptr() % 16 != 0
    before = binning.launches
    got = binning(xt, et)
    torch.cuda.synchronize()
    assert binning.launches == before + 1
    assert torch.equal(got, binning_ref(xt, et))


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


def test_fleet_on_the_card_shares_tables_and_serves_b1s_bits(card, tmp_path):
    """A 4-rung ladder fleet admitted on the card: the three codebook rungs
    hand B1 one ``thr_table`` pointer, and every routed score equals B1's on
    the model's own arrays to the bit."""
    from repro_torch.api import CompressionSpec
    from repro_torch.fleet import FleetEngine, ModelRegistry

    arrays = synthetic_forest(5, n_trees=32, max_depth=6, n_features=32, n_bins=64,
                              n_used_features=16, n_leaf_values=1024)
    cfg = GBDTConfig(task="binary", n_rounds=32, max_depth=6)
    m = ToadModel.from_forest(forest_from_numpy(arrays, 1, device="cpu"), cfg,
                              n_bins=64, device="cpu")
    rungs = {"a": CompressionSpec.codebook_full(6, 4),
             "b": CompressionSpec.codebook_full(6, 2),
             "c": CompressionSpec.thr_codebook(6), "d": CompressionSpec.exact()}
    for name, spec in rungs.items():
        m.compress(spec=spec).save(str(tmp_path / f"{name}.toad"))
    reg = ModelRegistry.from_dir(str(tmp_path), device=card)
    dps = {mid: reg.get(mid).model.device_packed() for mid in reg.ids()}
    assert len({dps[k].thr_table.data_ptr() for k in "abc"}) == 1
    assert all(dp.thr_table.device == card for dp in dps.values())
    x = _rows(arrays["edges"], 96, seed=3)
    before = packed_predict.launches
    with FleetEngine(reg, max_batch=32, max_wait_ms=1.0) as eng:
        futs = {mid: [eng.submit(mid, r) for r in x] for mid in reg.ids()}
        got = {mid: np.stack([f.result(timeout=60) for f in fs])
               for mid, fs in futs.items()}
        stats = eng.stats()
    assert set(stats.active_backend.values()) == {"cuda"}
    assert packed_predict.launches - before >= stats.fleet.n_batches
    xt = torch.from_numpy(x).to(card)
    for mid, dp in dps.items():
        b1 = packed_predict(xt, *dp.arrays(), **dp.meta()).cpu().numpy()
        np.testing.assert_array_equal(got[mid], b1, err_msg=mid)


@pytest.mark.parametrize("name", ["qwen3-4b", "olmoe-1b-7b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "whisper-small"])
def test_lm_serving_on_the_card_equals_the_cpu(card, name):
    """Prefill and 4 decode steps of the reduced config, the same seeded
    weights and tokens on both: within ``chip_smoke``'s [lm] bound (argmax
    agreement >= 0.95, atol 0.15, rtol 0.1, max|Δ| <= 0.0625)."""
    r = lm_card_equals_cpu(card, name)
    assert r["agree"] >= LM_ARGMAX and r["ok"], r


@pytest.mark.parametrize("name,grad_dtype", [
    *[(n, "f32") for n in ("qwen3-4b", "llama3.2-3b", "qwen1.5-32b", "stablelm-12b",
                           "olmoe-1b-7b", "llama4-maverick-400b-a17b", "llava-next-34b",
                           "rwkv6-1.6b", "whisper-small", "recurrentgemma-9b")],
    ("qwen3-4b", "bf16"), ("rwkv6-1.6b", "bf16")])
def test_lm_training_step_on_the_card_equals_the_cpu(card, name, grad_dtype):
    """One training step of the reduced config on the same float32 masters
    and batch: the loss and every gradient leaf within
    ``tests/test_torch_lm_train.py``'s bounds of the CPU's (an MoE config on
    the CPU's routes), and one optimizer update on the CPU's gradients
    within rtol 1e-6, atol 1e-7 (``chip_smoke``'s [lm-train] (a))."""
    r = lm_train_card_equals_cpu(card, name, grad_dtype)
    assert r["ok"], r


@pytest.mark.parametrize("name,info", DRYRUN_CASES, ids=[n for n, _ in DRYRUN_CASES])
def test_dryrun_meta_trace_holds_on_the_card(card, name, info):
    """``chip_smoke``'s [dryrun] at full width: the meta trace's FLOPs equal
    the card's step to the integer (a), its argument bytes are what
    placing the arguments as the training and serving CLIs place them adds
    to ``memory_allocated`` within the allocator's rounding (b), and the
    card's peak lies in
    ``DRYRUN_PEAK_BAND`` of the trace's (c)."""
    r = dryrun_check(card, name, info)
    assert r["ok_flops"], (r["meta_flops"], r["card_flops"])
    assert r["ok_args"], (r["arg_bytes"], r["placed"], r["slack"])
    assert r["ok_peak"], (r["meta_peak"], r["card_peak"], r["peak_ratio"])


@pytest.mark.parametrize("name,shape", [("qwen3-4b", (1, 4)), ("olmoe-1b-7b", (2, 2)),
                                        ("olmoe-1b-7b", (4, 1))]
                         + [(name, v[0]) for name, v in LM_MESH_REDUCED.items()], ids=str)
def test_lm_serving_on_a_mesh_on_the_card_equals_the_cpu(card, name, shape):
    """``chip_smoke``'s [lm-mesh] at reduced width: prefill and 3
    teacher-forced decode steps on a ``shape`` mesh of 4 gloo ranks sharing
    the card, each rank's logits within ``LM_CARD_MAX_ABS`` of the same rank
    on the CPU and its kept MoE slots equal; rwkv6 (one row, whole on every
    rank), recurrentgemma (past its window) and whisper as
    ``LM_MESH_REDUCED`` sets them, within ``LM_MESH_CARD_CPU`` or the
    family's one-device card = CPU reading on the same inputs where that is
    larger."""
    if name in LM_MESH_REDUCED:
        _, B, S, steps, split = LM_MESH_REDUCED[name]
        r = lm_mesh_card_equals_cpu(card, name, shape, B, S, steps, split, limit=None)
    else:
        r = lm_mesh_card_equals_cpu(card, name, shape)
    assert r["ok"], r
