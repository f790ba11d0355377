"""The port's data-parallel training and compressed collectives against the
JAX package, on the CPU.

One 4-rank gloo world, spawned once for the module (``run_ranks``: a
``FileStore`` rendezvous in a temporary directory), runs every case of the
port and returns its results; the JAX package runs its counterparts on 4
host devices (conftest's ``XLA_FLAGS``), each configuration under one
``jax.jit``.  The data is ``tests/test_distributed.py``'s.

Tolerances: trees equal (``feature``, ``thr_bin``, ``is_split``,
``leaf_ref``), leaf values within 2e-5 (``test_data_parallel_exact_parity``'s
bound: each shard sums its rows in float32, then the shards' sums are
added); a quantized all-reduce within one quantum (``scale``) of the JAX
package's, and equal to it at every other cell.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro import compat
from repro.distributed.collectives import ef_quantized_psum as jax_ef_quantized_psum
from repro.distributed.collectives import quantized_psum as jax_quantized_psum
from repro.gbdt import GBDTConfig as JaxConfig
from repro.gbdt import apply_bins as jax_apply_bins
from repro.gbdt import predict_binned as jax_predict_binned
from repro.gbdt import train_jit
from repro.gbdt.baselines import cegb_config as jax_cegb_config
from repro.gbdt.distributed import pad_to_shards as jax_pad_to_shards
from repro.gbdt.distributed import train_data_parallel as jax_train_data_parallel

from repro_torch._device import host
from repro_torch.distributed import ef_quantized_psum, quantized_psum
from repro_torch.gbdt import GBDTConfig, apply_bins, fit_bins, forest_to_numpy, predict_binned, train
from repro_torch.gbdt.baselines import cegb_config
from repro_torch.gbdt.distributed import (
    pad_to_shards,
    run_ranks,
    shard_rows,
    spawn_data_parallel,
    train_data_parallel,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 host devices (see conftest XLA_FLAGS)"
)

WORLD = 4
BASE = dict(task="binary", n_rounds=10, max_depth=3)
CEGB_TRADEOFF = 8.0  # JAX's data-parallel CEGB grows 61 splits here, its single fit 69
TREE = ("feature", "thr_bin", "is_split", "leaf_ref")
EF_STEPS = 30


def _configs(make, cegb):
    """The data-parallel fits of the world, as ``make(**fields)`` configs."""
    return {
        "exact": make(**BASE),
        "q16": make(**BASE, hist_quant_bits=16),
        "q8": make(**BASE, hist_quant_bits=8),
        "cegb": cegb(make(**BASE), tradeoff=CEGB_TRADEOFF),
    }


def _data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(2048, 6)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] > 0).astype(np.float32)
    edges = fit_bins(X, 32)
    return X, y, edges


def _collective_inputs():
    rng = np.random.default_rng(0)
    return dict(
        x=rng.normal(size=(WORLD, 64)).astype(np.float32) * 3.0,
        equal=np.tile(np.array([1.0, 0.5, -1.0], np.float32), (WORLD, 1)),
        ef=rng.normal(size=(WORLD, 64)).astype(np.float32),
    )


def _world(rank, device, bins, y, edges, coll):
    """One rank of the module's world: every data-parallel fit, then the
    collectives on this rank's inputs."""
    bins = shard_rows(torch.from_numpy(bins), rank, WORLD).to(device)
    y = shard_rows(torch.from_numpy(y), rank, WORLD).to(device)
    edges = torch.from_numpy(edges).to(device)
    out = {}
    for name, cfg in _configs(GBDTConfig, cegb_config).items():
        forest, history, aux = train_data_parallel(cfg, bins, y, edges)
        out[name] = dict(forest=forest_to_numpy(forest),
                         history={k: host(v) for k, v in history.items()},
                         preds=host(aux["preds"]))
    x = torch.from_numpy(coll["x"][rank])
    equal = torch.from_numpy(coll["equal"][rank])
    out["psum"] = {bits: host(quantized_psum(x, bits=bits)) for bits in (8, 16)}
    out["psum_equal"] = {bits: host(quantized_psum(equal, bits=bits)) for bits in (8, 16)}
    signal, err = torch.from_numpy(coll["ef"][rank]), torch.zeros(64)
    ef = []
    for _ in range(EF_STEPS):
        total, err = ef_quantized_psum(signal, err, bits=8)
        ef.append(host(total))
    out["ef"] = np.stack(ef)
    return out


@pytest.fixture(scope="module")
def data():
    X, y, edges = _data()
    bins = apply_bins(torch.from_numpy(X), torch.from_numpy(edges)).numpy()
    return X, y, edges, bins


@pytest.fixture(scope="module")
def world(data):
    """Every rank's results of :func:`_world`, in rank order."""
    X, y, edges, bins = data
    return run_ranks(_world, WORLD, bins, y, edges, _collective_inputs(), device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(WORLD), ("data",))


@pytest.fixture(scope="module")
def jax_runs(data, mesh):
    """The JAX package's data-parallel and single fits of each configuration."""
    X, y, edges, _ = data
    jbins = jax_apply_bins(jnp.asarray(X), jnp.asarray(edges))
    args = (jbins, jnp.asarray(y), jnp.asarray(edges))
    dp = jax.jit(jax_train_data_parallel, static_argnums=(0, 4))
    cache = {}

    def get(name, parallel=True):
        if (name, parallel) not in cache:
            cfg = _configs(JaxConfig, jax_cegb_config)[name]
            run = dp(cfg, *args, mesh) if parallel else train_jit(cfg, *args)
            cache[name, parallel] = jax.tree.map(np.asarray, run)
        return cache[name, parallel]

    return get


@pytest.fixture(scope="module")
def single(data):
    """The port's single-process fits of each configuration."""
    X, y, edges, bins = data
    cache = {}

    def get(name):
        if name not in cache:
            cfg = _configs(GBDTConfig, cegb_config)[name]
            cache[name] = train(cfg, torch.from_numpy(bins), torch.from_numpy(y),
                                torch.from_numpy(edges))
        return cache[name]

    return get


def _same_trees(a: dict, b, label):
    get = (lambda k: np.asarray(getattr(b, k))) if not isinstance(b, dict) else b.get
    for k in TREE:
        np.testing.assert_array_equal(a[k], get(k), err_msg=f"{label}: {k}")
    np.testing.assert_allclose(a["leaf_values"], get("leaf_values"), atol=2e-5, err_msg=label)


def _accuracy(forest: dict, bins, y) -> float:
    from repro_torch.gbdt import forest_from_numpy

    f = forest_from_numpy(forest, device="cpu")
    return float(((predict_binned(f, torch.from_numpy(bins))[:, 0] > 0).numpy() == y).mean())


def test_data_parallel_equals_single_process_and_jax(world, single, jax_runs, data):
    X, y, edges, bins = data
    f_single, h_single, aux_single = single("exact")
    f_jax, h_jax, _ = jax_runs("exact")
    for rank, out in enumerate(world):
        _same_trees(out["exact"]["forest"], f_single, f"rank {rank} vs one process")
        _same_trees(out["exact"]["forest"], f_jax, f"rank {rank} vs JAX")
        for k, v in out["exact"]["history"].items():
            if k != "bytes":
                np.testing.assert_array_equal(v, np.asarray(h_jax[k]), err_msg=k)
    preds = np.concatenate([out["exact"]["preds"] for out in world])
    np.testing.assert_allclose(preds, aux_single["preds"].numpy(), atol=2e-5)


@pytest.mark.parametrize("bits", [16, 8])
def test_quantized_collectives_grow_the_jax_trees(world, jax_runs, bits):
    f_jax = jax_runs(f"q{bits}")[0]
    for rank, out in enumerate(world):
        _same_trees(out[f"q{bits}"]["forest"], f_jax, f"rank {rank}, {bits} bits")


@pytest.mark.parametrize("bits", [16, 8])
def test_quantized_histogram_collective_quality(world, data, bits):
    X, y, edges, bins = data
    acc_e = _accuracy(world[0]["exact"]["forest"], bins, y)
    acc_q = _accuracy(world[0][f"q{bits}"]["forest"], bins, y)
    assert acc_q > acc_e - 0.02


def _jax_collective(mesh, fn, n_args=1):
    """``fn`` on each of the 4 host devices' rows of its (4, ...) arguments,
    under one jit; returns numpy results with a leading (4,) axis."""
    mapped = jax.jit(compat.shard_map(
        lambda *a: jax.tree.map(lambda o: o[None], fn(*(v[0] for v in a))),
        mesh=mesh, in_specs=(P("data"),) * n_args, out_specs=P("data"), check_vma=False))
    return lambda *xs: jax.tree.map(np.asarray, mapped(*map(jnp.asarray, xs)))


def _scale(x: np.ndarray, bits: int) -> np.float32:
    qmax = np.float32(2 ** (bits - 1) - 1)
    return np.float32(np.abs(x).max()) * np.float32(WORLD) / qmax


@pytest.mark.parametrize("bits", [16, 8])
def test_quantized_psum_within_one_quantum_of_jax(world, mesh, bits):
    x = _collective_inputs()["x"]
    want = _jax_collective(mesh, partial(jax_quantized_psum, axis_name="data", bits=bits))(x)[0]
    scale = _scale(x, bits)
    for out in world:
        got = out["psum"][bits]
        # one quantum, plus the float32 rounding of the two dequantized sums
        assert np.all(np.abs(got - want) <= scale + 2 * np.spacing(np.abs(want)))
        # the clip acts only where a shard rounds past floor(qmax / n)
        qlim = (2 ** (bits - 1) - 1) // WORLD
        clipped = (np.abs(np.round(x / scale)) > qlim).any(axis=0)
        np.testing.assert_allclose(got[~clipped], want[~clipped], rtol=1e-6, atol=1e-6 * scale)
        np.testing.assert_allclose(got, x.sum(axis=0), atol=WORLD * scale)


def test_sixteen_bit_carrier_equals_the_int16_sum(world):
    """The 16-bit payload moves in int32; its sum equals the sum of the
    shards' integers taken in int16 (which wraps if it overflows)."""
    x = _collective_inputs()["x"]
    scale = _scale(x, 16)
    q = np.clip(np.round(x / scale), -(32767 // WORLD), 32767 // WORLD).astype(np.int16)
    int16_sum = np.sum(q, axis=0, dtype=np.int16)
    np.testing.assert_array_equal(int16_sum, q.astype(np.int64).sum(axis=0))
    carried = np.round(world[0]["psum"][16] / scale).astype(np.int64)
    np.testing.assert_array_equal(carried, int16_sum)


@pytest.mark.parametrize("bits", [16, 8])
def test_quantized_psum_cannot_wrap_where_jax_does(world, mesh, bits):
    """Four shards at the shared maximum: each rounds qmax / 4 up, and the
    JAX package's int8/int16 sum wraps to the wrong sign (ROADMAP queue C);
    the port clips each shard to floor(qmax / 4) and keeps the sign."""
    equal = _collective_inputs()["equal"]
    true = equal.sum(axis=0)
    psum = _jax_collective(mesh, partial(jax_quantized_psum, axis_name="data", bits=bits))
    jax_out = psum(equal)[0]
    assert jax_out[0] < 0 < true[0]
    got = world[0]["psum_equal"][bits]
    np.testing.assert_array_equal(np.sign(got), np.sign(true))
    np.testing.assert_allclose(got, true, atol=WORLD * _scale(equal, bits))


def test_ef_quantized_psum_matches_jax_and_is_unbiased_over_steps(world, mesh):
    xs = _collective_inputs()["ef"]

    step = _jax_collective(mesh, partial(jax_ef_quantized_psum, axis_name="data", bits=8), 2)
    err = np.zeros_like(xs)
    acc_q = np.zeros(64)
    for t in range(EF_STEPS):
        # the step's quantum: max |x + err| / 127, the residual below half of one
        quantum = np.float32(np.abs(xs + err).max()) / np.float32(127)
        out, err = step(xs, err)
        for rank_out in world:
            np.testing.assert_allclose(rank_out["ef"][t], out[0], rtol=0, atol=quantum)
        acc_q += world[0]["ef"][t]
    # error feedback keeps the *accumulated* signal unbiased
    acc_t = xs.sum(axis=0) * EF_STEPS
    assert np.abs(acc_q - acc_t).max() / np.abs(acc_t).max() < 0.01


def test_cegb_data_parallel_charges_the_global_rows(world, single, jax_runs):
    """The port's data-parallel CEGB fit grows its single-process trees; the
    JAX package's divides the split cost by the shard's rows and grows
    others (ROADMAP queue C)."""
    f_single = single("cegb")[0]
    for rank, out in enumerate(world):
        _same_trees(out["cegb"]["forest"], f_single, f"rank {rank}")
    jax_dp, jax_one = jax_runs("cegb")[0], jax_runs("cegb", parallel=False)[0]
    _same_trees(forest_to_numpy(f_single), jax_one, "port vs JAX, one process")
    assert not np.array_equal(np.asarray(jax_dp.is_split), np.asarray(jax_one.is_split))
    assert int(np.asarray(jax_dp.is_split).sum()) < int(np.asarray(jax_one.is_split).sum())


@pytest.mark.parametrize("n,shards,pad_value", [(10, 4, 0), (12, 4, 0), (7, 3, -1), (1, 8, 5)])
def test_pad_to_shards_equals_jax(n, shards, pad_value):
    x = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    np.testing.assert_array_equal(pad_to_shards(x, shards, pad_value),
                                  jax_pad_to_shards(x, shards, pad_value))


def test_shard_rows_is_the_layout_of_jax_data_sharding(mesh):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    placed = jax.device_put(x, NamedSharding(mesh, P("data")))
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for rank, dev in enumerate(mesh.devices):
        np.testing.assert_array_equal(shard_rows(x, rank, WORLD), by_device[dev])
    with pytest.raises(ValueError, match="pad_to_shards"):
        shard_rows(x[:15], 0, WORLD)


def test_spawn_data_parallel_returns_rank_zero_and_every_rank_s_rows(data, single):
    X, y, edges, bins = data
    forest, history, aux = spawn_data_parallel(
        GBDTConfig(**BASE), bins, y, edges, world_size=2, device="cpu")
    f_single, h_single, aux_single = single("exact")
    _same_trees(forest_to_numpy(forest), f_single, "spawned, 2 ranks")
    np.testing.assert_array_equal(history["n_splits"].numpy(), h_single["n_splits"].numpy())
    np.testing.assert_allclose(aux["preds"].numpy(), aux_single["preds"].numpy(), atol=2e-5)
    assert aux["rank_histogram_launches"] == [0, 0]  # the CPU runs the plain version
    assert len(aux["rank_train_seconds"]) == 2 and min(aux["rank_train_seconds"]) > 0


def test_deprecated_kwarg_warns_and_the_group_must_exist(data):
    X, y, edges, bins = data
    args = (torch.from_numpy(bins), torch.from_numpy(y), torch.from_numpy(edges))
    with pytest.warns(DeprecationWarning, match="hist_quant_bits"), \
            pytest.raises(RuntimeError, match="not initialised"):
        train_data_parallel(GBDTConfig(**BASE), *args, hist_quant_bits=8)
    # one process: the kwarg sets the config and, as in JAX, does nothing else
    with pytest.warns(DeprecationWarning, match="hist_quant_bits"):
        f, _, _ = train(dataclasses.replace(GBDTConfig(**BASE), n_rounds=2), *args,
                        hist_quant_bits=16)
    g, _, _ = train(dataclasses.replace(GBDTConfig(**BASE), n_rounds=2), *args)
    for k in TREE + ("leaf_values",):
        assert torch.equal(getattr(f, k), getattr(g, k)), k


def _fail_on_rank_one(rank, device):
    if rank == 1:
        raise ValueError("rank one fails")
    torch.distributed.all_reduce(torch.ones(3))  # the others wait for rank 1
    return rank


def test_a_failing_rank_stops_the_world_with_its_traceback():
    import multiprocessing

    with pytest.raises(RuntimeError, match="ValueError: rank one fails"):
        run_ranks(_fail_on_rank_one, WORLD, device="cpu")
    assert not multiprocessing.active_children()


def test_spawn_data_parallel_refuses_without_a_card(data, monkeypatch):
    X, y, edges, bins = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn_data_parallel(GBDTConfig(**BASE), bins, y, edges)
