"""The port's histogram path against the JAX package's, on the CPU.

The same inputs, drawn with numpy, go through JAX's ``histogram`` (the
Pallas kernel in interpret mode, its default off the TPU) and
``histogram_ref``, and through the port's ``build_histogram`` for every
method (``cuda`` runs the kernel's plain version on a CPU tensor) and
``sibling_subtraction_histograms``.  Contract: within 1e-5, counts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.histogram import histogram as jax_histogram
from repro.kernels.ops import build_histogram as jax_build_histogram
from repro.kernels.ops import sibling_subtraction_histograms as jax_sibling
from repro.kernels.ref import histogram_ref as jax_histogram_ref

from repro_torch.kernels import _build
from repro_torch.kernels.histogram import histogram, histogram_fused
from repro_torch.kernels.ops import (
    HIST_METHODS,
    build_histogram,
    default_hist_method,
    resolve_hist_method,
    sibling_subtraction_histograms,
)
from repro_torch.kernels.ref import histogram_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n, d, n_bins, n_nodes, seed, ch=3):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, (n, d)).astype(np.int32)
    gh = np.stack([rng.normal(size=n), rng.uniform(0.1, 1.0, n), np.ones(n)]
                  + [rng.normal(size=n) for _ in range(ch - 3)], axis=-1)[:, :ch]
    # the last node stays empty
    pos = rng.integers(0, max(n_nodes - 1, 1), (n,)).astype(np.int32)
    return bins, gh.astype(np.float32), pos


def _torch(bins, gh, pos, bins_dtype=torch.uint8):
    return (torch.from_numpy(bins).to(bins_dtype), torch.from_numpy(gh),
            torch.from_numpy(pos))


@pytest.mark.parametrize("method", HIST_METHODS)
@pytest.mark.parametrize("n", [64, 513])
@pytest.mark.parametrize("d", [1, 7])
@pytest.mark.parametrize("n_bins", [16, 256])
@pytest.mark.parametrize("n_nodes", [1, 9])
def test_build_histogram_matches_jax(method, n, d, n_bins, n_nodes):
    bins, gh, pos = _inputs(n, d, n_bins, n_nodes, seed=n * d + n_bins + n_nodes)
    pallas = np.asarray(jax_histogram(jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(pos),
                                      n_nodes=n_nodes, n_bins=n_bins))
    ref = np.asarray(jax_histogram_ref(jnp.asarray(bins), jnp.asarray(gh),
                                       jnp.asarray(pos), n_nodes, n_bins))
    out = build_histogram(*_torch(bins, gh, pos), n_nodes=n_nodes, n_bins=n_bins,
                          method=method)
    assert out.dtype == torch.float32
    assert out.shape == (n_nodes, d, n_bins, 3)
    got = out.numpy()
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])  # counts exact
    assert got[..., 2].sum() == n * d
    if n_nodes > 1:
        np.testing.assert_array_equal(got[n_nodes - 1], 0.0)  # the empty node
    if method != "fused":
        # index_add_ in row order is segment_sum's order: equal to the bit
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("method", HIST_METHODS)
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_half_precision_channels_accumulate_in_fp32(method, dtype):
    """bf16/f16 channels are cast up and summed in fp32, against the JAX
    package's Pallas kernel on the same rounded values; out-of-range pos
    (negative and past the last node) is dropped and the last node stays
    empty."""
    n, d, n_bins, n_nodes = 513, 5, 64, 8
    bins, gh, pos = _inputs(n, d, n_bins, n_nodes, seed=11)
    rng = np.random.default_rng(12)
    pos[rng.random(n) < 0.1] = n_nodes
    pos[rng.random(n) < 0.1] = -1
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "f16": (torch.float16, jnp.float16)}[dtype]
    gh_half = torch.from_numpy(gh).to(tdt)
    rounded = gh_half.to(torch.float32).numpy()
    want = np.asarray(jax_build_histogram(
        jnp.asarray(bins), jnp.asarray(gh).astype(jdt),
        jnp.asarray(pos), n_nodes=n_nodes, n_bins=n_bins, method="pallas"))
    ref = np.asarray(jax_histogram_ref(
        jnp.asarray(bins), jnp.asarray(rounded), jnp.asarray(np.where(
            (pos >= 0) & (pos < n_nodes), pos, n_nodes)), n_nodes, n_bins))
    out = build_histogram(torch.from_numpy(bins).to(torch.uint8), gh_half,
                          torch.from_numpy(pos), n_nodes=n_nodes, n_bins=n_bins,
                          method=method)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_array_equal(out.numpy()[..., 2], ref[..., 2])
    kept = int(((pos >= 0) & (pos < n_nodes)).sum())
    assert out[..., 2].sum().item() == kept * d
    np.testing.assert_array_equal(out.numpy()[n_nodes - 1], 0.0)


@pytest.mark.parametrize("method", HIST_METHODS)
@pytest.mark.parametrize("n_parents", [1, 4])
def test_sibling_subtraction_matches_jax_and_direct(method, n_parents):
    rng = np.random.default_rng(n_parents)
    n, d, n_bins = 600, 4, 32
    bins, gh, _ = _inputs(n, d, n_bins, 1, seed=n_parents)
    parent = rng.integers(0, n_parents, (n,))
    went_left = rng.random(n) < 0.5
    went_left[parent == 0] = True  # parent 0: empty right child
    child = (2 * parent + np.where(went_left, 0, 1)).astype(np.int32)
    tb, tg, _ = _torch(bins, gh, child)
    parent_hist = build_histogram(tb, tg, torch.from_numpy(parent.astype(np.int32)),
                                  n_nodes=n_parents, n_bins=n_bins, method=method)
    out = sibling_subtraction_histograms(tb, tg, torch.from_numpy(child), parent_hist,
                                         n_bins=n_bins, method=method)
    direct = build_histogram(tb, tg, torch.from_numpy(child), n_nodes=2 * n_parents,
                             n_bins=n_bins, method=method)
    jparent = jax_build_histogram(jnp.asarray(bins), jnp.asarray(gh),
                                  jnp.asarray(parent, jnp.int32), n_nodes=n_parents,
                                  n_bins=n_bins, method="ref")
    want = np.asarray(jax_sibling(jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(child),
                                  jparent, n_bins=n_bins, method="ref"))
    np.testing.assert_allclose(out.numpy(), direct.numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    np.testing.assert_array_equal(out.numpy()[..., 2], direct.numpy()[..., 2])


def test_bin_layouts_and_types_agree():
    """uint8 and int32 bins, row-major, column-major and strided views (rows
    of a column-major tensor, every other feature), give the same bits."""
    bins, gh, pos = _inputs(300, 6, 256, 5, seed=3)
    base = histogram(*_torch(bins, gh, pos, torch.int32), n_nodes=5, n_bins=256)
    wide = np.repeat(np.concatenate([bins, bins[:20]]), 2, axis=1)  # (320, 12)
    for dtype in (torch.uint8, torch.int32):
        b = torch.from_numpy(bins).to(dtype)
        w = torch.from_numpy(wide).to(dtype)
        for layout in (b, b.t().contiguous().t(), w.t().contiguous().t()[:300, ::2]):
            out = histogram(layout, torch.from_numpy(gh), torch.from_numpy(pos),
                            n_nodes=5, n_bins=256)
            assert torch.equal(out, base)


def test_fused_path_matches_ref_with_channels_2():
    bins, gh, pos = _inputs(257, 3, 32, 4, seed=5)
    tb, tg, tp = _torch(bins, gh[:, :2], pos)
    np.testing.assert_allclose(histogram_fused(tb, tg, tp, n_nodes=4, n_bins=32).numpy(),
                               histogram_ref(tb, tg, tp, 4, 32).numpy(), **TOL)


def test_wrapper_checks_inputs_on_the_cpu_as_on_the_card():
    bins, gh, pos = _inputs(40, 3, 16, 2, seed=1)
    tb, tg, tp = _torch(bins, gh, pos)
    before = histogram.launches
    bad = [
        (dict(bins=tb.to(torch.int64)), "uint8 or int32"),
        (dict(bins=tb[:, None]), "must be \\(n, d\\)"),
        (dict(gh=tg[:10]), "gh must be"),
        (dict(gh=torch.ones((40, 9))), "CH must be"),
        (dict(gh=tg.to(torch.int32)), "floating point"),
        (dict(pos=tp.to(torch.int64)), "pos must be"),
    ]
    for override, match in bad:
        args = dict(bins=tb, gh=tg, pos=tp) | override
        with pytest.raises(ValueError, match=match):
            histogram(**args, n_nodes=2, n_bins=16)
    with pytest.raises(ValueError, match="shared memory"):
        histogram(tb.to(torch.int32), tg, tp, n_nodes=2, n_bins=20_000)
    assert histogram.launches == before  # the CPU runs the plain version


def test_empty_rows_give_zeros():
    out = histogram(torch.zeros((0, 4), dtype=torch.uint8), torch.zeros((0, 3)),
                    torch.zeros((0,), dtype=torch.int32), n_nodes=3, n_bins=8)
    assert out.shape == (3, 4, 8, 3) and not out.any()


def test_method_names():
    assert HIST_METHODS == ("ref", "fused", "cuda")
    assert default_hist_method() == "cuda"
    assert resolve_hist_method(None) == resolve_hist_method("auto") == "cuda"
    # a configuration written by the JAX package names its TPU kernel
    assert resolve_hist_method("pallas") == "cuda"
    with pytest.raises(ValueError, match="unknown histogram method"):
        resolve_hist_method("mxu")
    with pytest.raises(ValueError, match="unknown histogram method"):
        build_histogram(torch.zeros((4, 1), dtype=torch.uint8), torch.ones((4, 3)),
                        torch.zeros(4, dtype=torch.int32), n_nodes=1, n_bins=2,
                        method="segment")


def test_kernel_source_is_built_with_the_others():
    assert {"histogram", "packed_predict"} <= set(_build.sources())


def test_sibling_subtraction_reduces_left_children_before_subtracting():
    """``reduce_fn`` (the cross-shard sum of data-parallel training) acts on
    the left children only; here two identical shards: twice every sum."""
    bins, gh, pos = _inputs(400, 3, 16, 6, seed=9)
    tb, tg, tp = _torch(bins, gh, pos)
    parent = torch.div(tp, 2, rounding_mode="floor")
    parent_hist = 2 * build_histogram(tb, tg, parent, n_nodes=3, n_bins=16)
    out = sibling_subtraction_histograms(tb, tg, tp, parent_hist, n_bins=16,
                                         reduce_fn=lambda left: 2 * left)
    direct = build_histogram(tb, tg, tp, n_nodes=6, n_bins=16)
    np.testing.assert_allclose(out.numpy(), 2 * direct.numpy(), **TOL)
