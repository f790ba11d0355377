"""The port's binning path (kernel B4's wrapper and plain version) against
the JAX package's, on the CPU.

The same inputs, drawn with numpy, go through JAX's ``binning`` (the
Pallas kernel in interpret mode, its default off the TPU), its
``binning_ref`` and ``apply_bins``, and through the port's ``binning_ref``,
``kernels.binning.binning`` and ``ops.apply_binning(device="cpu")`` (a CPU
tensor runs the kernel's plain version).  Contract: equal element by
element.  One known split inside the reference: on NaN the Pallas kernel
returns 0 (``x > e`` is false), while JAX's ``binning_ref`` and
``apply_bins`` return ``E``; the port follows ``apply_bins``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.gbdt import apply_bins as jax_apply_bins
from repro.kernels.binning import binning as jax_binning
from repro.kernels.ref import binning_ref as jax_binning_ref

from repro_torch.gbdt import apply_bins
from repro_torch.kernels.binning import binning
from repro_torch.kernels.ops import apply_binning
from repro_torch.kernels.ref import EDGE_CHUNK, binning_ref


def _inputs(n, d, e, seed, nan=0.0, inf_tail=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    edges = np.sort(rng.normal(size=(d, e)), axis=1).astype(np.float32)
    if inf_tail and e > 3:
        edges[:, -2:] = np.inf  # invalid candidates never count
    x[rng.random(x.shape) < nan] = np.nan
    return x, edges


def _port(x, edges):
    """The port's three entry points on the same inputs, as numpy."""
    xt, et = torch.from_numpy(x), torch.from_numpy(edges)
    outs = (binning_ref(xt, et), binning(xt, et), apply_binning(x, edges, device="cpu"))
    for o in outs:
        assert o.dtype == torch.int32 and tuple(o.shape) == x.shape
    return [o.numpy() for o in outs]


@given(
    n=st.integers(1, 700),
    d=st.integers(1, 9),
    e=st.integers(1, 40),
    seed=st.integers(0, 100),
)
@settings(max_examples=12, deadline=None)
def test_binning_property_matches_the_pallas_kernel(n, d, e, seed):
    """As ``test_binning_property``: on non-NaN inputs the port equals the
    Pallas kernel (interpret mode) and JAX's plain version."""
    x, edges = _inputs(n, d, e, seed)
    pallas = np.asarray(jax_binning(jnp.asarray(x), jnp.asarray(edges)))
    ref = np.asarray(jax_binning_ref(jnp.asarray(x), jnp.asarray(edges)))
    np.testing.assert_array_equal(pallas, ref)
    for out in _port(x, edges):
        np.testing.assert_array_equal(out, pallas)


@pytest.mark.parametrize("n,d,e", [(1, 1, 1), (511, 9, 40), (513, 9, 255),
                                   (700, 3, EDGE_CHUNK + 1), (64, 256, 255)])
def test_binning_matches_jax_ref_and_apply_bins_with_nan_and_inf(n, d, e):
    """On every input, NaN and ±inf included, the port equals JAX's
    ``binning_ref`` and ``apply_bins`` (the bins ``fit``/``predict_raw``
    use), and its own ``apply_bins``."""
    x, edges = _inputs(n, d, e, seed=n + d + e, nan=0.05)
    rng = np.random.default_rng(e)
    x[rng.random(x.shape) < 0.02] = np.inf
    x[rng.random(x.shape) < 0.02] = -np.inf
    edges[0] = np.inf  # a feature whose edges are all +inf
    want = np.asarray(jax_binning_ref(jnp.asarray(x), jnp.asarray(edges)))
    np.testing.assert_array_equal(
        np.asarray(jax_apply_bins(jnp.asarray(x), jnp.asarray(edges))), want)
    np.testing.assert_array_equal(
        apply_bins(torch.from_numpy(x), torch.from_numpy(edges)).numpy(), want)
    for out in _port(x, edges):
        np.testing.assert_array_equal(out, want)


def test_values_on_an_edge_stay_left():
    """As ``test_binning_boundary_semantics``: bin = #{edges < x}, so x
    exactly on an edge stays left (x <= edge); one ulp above goes right."""
    one = np.float32(1.0)
    x = np.asarray([[1.0], [1.0 + 1e-6], [0.999999],
                    [np.nextafter(one, np.float32(2))],
                    [np.nextafter(one, np.float32(0))]], np.float32)
    edges = np.asarray([[1.0]], np.float32)
    want = [[0], [1], [0], [1], [0]]
    assert np.asarray(jax_binning(jnp.asarray(x), jnp.asarray(edges))).tolist() == want
    for out in _port(x, edges):
        assert out.tolist() == want


def test_nan_split_inside_the_reference_is_pinned():
    """x = [nan], edges = [0, 1, inf]: the Pallas kernel gives 0, JAX's
    ``binning_ref`` and ``apply_bins`` give E = 3, and so does the port."""
    x = np.asarray([[np.nan]], np.float32)
    edges = np.asarray([[0.0, 1.0, np.inf]], np.float32)
    assert int(np.asarray(jax_binning(jnp.asarray(x), jnp.asarray(edges)))[0, 0]) == 0
    assert int(np.asarray(jax_binning_ref(jnp.asarray(x), jnp.asarray(edges)))[0, 0]) == 3
    assert int(np.asarray(jax_apply_bins(jnp.asarray(x), jnp.asarray(edges)))[0, 0]) == 3
    for out in _port(x, edges):
        assert int(out[0, 0]) == 3


def test_no_edges_and_no_rows():
    x = np.ones((5, 2), np.float32)
    for out in _port(x, np.zeros((2, 0), np.float32)):
        np.testing.assert_array_equal(out, np.zeros((5, 2), np.int32))
    empty = _port(np.zeros((0, 2), np.float32), np.zeros((2, 4), np.float32))
    assert all(o.shape == (0, 2) for o in empty)


def test_inputs_are_cast_to_float32_as_jax_casts_them():
    x, edges = _inputs(100, 4, 20, seed=3)
    want = binning(torch.from_numpy(x), torch.from_numpy(edges))
    got = binning(torch.from_numpy(x.astype(np.float64)),
                  torch.from_numpy(edges.astype(np.float16)).to(torch.float32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("x,edges,match", [
    (np.zeros((4, 3), np.float32), np.zeros((2, 5), np.float32), "features"),
    (np.zeros(4, np.float32), np.zeros((1, 5), np.float32), "2-D"),
    (np.zeros((4, 3), np.float32), np.zeros(5, np.float32), "2-D"),
    (np.zeros((3, 4), np.float32).T, np.zeros((3, 5), np.float32), "contiguous"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(x, edges, match):
    with pytest.raises(ValueError, match=match):
        binning(torch.from_numpy(x), torch.from_numpy(edges))
    with pytest.raises(ValueError, match="torch.Tensor"):
        binning(np.zeros((4, 3), np.float32), torch.zeros((3, 5)))


def test_entry_point_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        apply_binning(np.zeros((2, 2), np.float32), np.zeros((2, 3), np.float32))
