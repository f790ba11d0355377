"""The port's checkpoints against the JAX package's on-disk format, on the
CPU: a checkpoint written by either package restores in the other, with
zlib and with zstd shards; the port's MessagePack subset against the
``msgpack`` package; the atomic publish.  Every comparison is exact."""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_reduced as jax_get_reduced
from repro.distributed import checkpoint as jax_ckpt
from repro.models.registry import get_model as jax_get_model
from repro.train import loop as jax_loop

from repro_torch.configs import get_reduced
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import msgpack_lite
from repro_torch.models import get_model
from repro_torch.train import adamw, fit, lm_batch_fn

from test_torch_lm_train import leaves


def _np_tree():
    """f32, bf16 and int32 leaves, a 0-d one, a nested list."""
    rng = np.random.default_rng(0)
    return {
        "w": rng.normal(size=(4, 3)).astype(np.float32),
        "nested": {"b": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
                   "layers": [rng.integers(-9, 9, size=(2, 2)).astype(np.int32),
                              {"s": np.asarray(3.5, np.float32)}]},
        "step": np.asarray(7, np.int32),
    }


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _as_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


@pytest.fixture(params=["zlib", "zstd"])
def codec(request, monkeypatch):
    """Both packages writing ``request.param`` shards (reading sniffs)."""
    if request.param == "zstd":
        pytest.importorskip("zstandard")
    else:
        monkeypatch.setattr(ckpt, "zstandard", None)
        monkeypatch.setattr(jax_ckpt, "zstandard", None)
        monkeypatch.setattr(jax_ckpt, "_CCTX", jax_ckpt._Codec())
    return request.param


def _shard_codec(path):
    with open(os.path.join(path, "shard-0.mpz"), "rb") as f:
        shards = msgpack_lite.unpackb(f.read())
    magics = {bytes(rec["data"][:4]) == ckpt._ZSTD_MAGIC for rec in shards.values()}
    return {True: "zstd", False: "zlib"}[magics.pop()] if len(magics) == 1 else "mixed"


def test_jax_save_restores_in_the_port(tmp_path, codec):
    tree = _np_tree()
    path = jax_ckpt.save(str(tmp_path), 7, jax.tree.map(jnp.asarray, tree))
    assert _shard_codec(path) == codec
    assert ckpt.latest_step(str(tmp_path)) == 7
    got = ckpt.restore(str(tmp_path), 7, _map(_torch, tree), device="cpu")
    for (p, a), (q, b) in zip(leaves(got), leaves(tree)):
        assert p == q and _as_np(a).dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(_as_np(a), b, err_msg=p)


def test_port_save_restores_in_jax(tmp_path, codec):
    tree = _np_tree()
    path = ckpt.save(str(tmp_path), 3, _map(_torch, tree))
    assert os.path.basename(path) == "step-3" and _shard_codec(path) == codec
    assert jax_ckpt.latest_step(str(tmp_path)) == 3
    got = jax_ckpt.restore(str(tmp_path), 3, jax.tree.map(jnp.asarray, tree))
    for (p, a), (_, b) in zip(leaves(got), leaves(tree)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_both_packages_write_the_same_keys_and_manifest(tmp_path):
    tree = _np_tree()
    a = jax_ckpt.save(str(tmp_path / "jax"), 1, jax.tree.map(jnp.asarray, tree))
    b = ckpt.save(str(tmp_path / "port"), 1, _map(_torch, tree))
    with open(os.path.join(a, "manifest.json")) as f:
        ma = json.load(f)
    with open(os.path.join(b, "manifest.json")) as f:
        mb = json.load(f)
    assert ma == mb
    assert "['nested']['layers'][1]['s']" in mb["leaves"]
    keys = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(mb["leaves"]) == keys
    with open(os.path.join(a, "shard-0.mpz"), "rb") as f:
        sa = msgpack_lite.unpackb(f.read())
    with open(os.path.join(b, "shard-0.mpz"), "rb") as f:
        sb = msgpack_lite.unpackb(f.read())
    assert list(sa) == list(sb) == keys
    for k in keys:
        assert {n: sa[k][n] for n in ("index", "dtype", "shape")} == \
               {n: sb[k][n] for n in ("index", "dtype", "shape")}, k
        assert ckpt.decompress(sa[k]["data"]) == ckpt.decompress(sb[k]["data"]), k


SUBSET = [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
    b"", b"x" * 255, b"y" * 256, b"z" * 65536,
    [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {f"k{i}": i for i in range(15)}, {f"k{i}": [i, b"v"] for i in range(16)},
    {str(i): {"index": [[0, i]], "data": bytes(i % 7), "dtype": "float32", "shape": [i]}
     for i in range(70000)},
]


@pytest.mark.parametrize("obj", SUBSET, ids=lambda o: type(o).__name__ + str(len(str(o))))
def test_msgpack_subset_against_the_package(obj):
    msgpack = pytest.importorskip("msgpack")
    mine = msgpack_lite.packb(obj)
    assert mine == msgpack.packb(obj, use_bin_type=True)
    assert msgpack.unpackb(mine, raw=False) == msgpack_lite.unpackb(mine) == obj


def test_msgpack_subset_refuses_other_types():
    for obj in (-1, 1.5, None, True, {1: 2}.keys()):
        with pytest.raises(TypeError):
            msgpack_lite.packb(obj)
    for data in (b"\xc0", b"\xcb" + bytes(8), b"\xff", b"\xa3ab"):
        with pytest.raises(ValueError):
            msgpack_lite.unpackb(data)


def test_interrupted_save_leaves_no_step_and_latest_ignores_tmp(tmp_path, monkeypatch):
    tree = _map(_torch, _np_tree())
    ckpt.save(str(tmp_path), 2, tree)
    calls = []

    def failing(data):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk full")
        return ckpt.zlib.compress(data, 3)

    monkeypatch.setattr(ckpt, "compress", failing)
    with pytest.raises(OSError):
        ckpt.save(str(tmp_path), 4, tree)
    assert sorted(os.listdir(tmp_path)) == ["step-2", "tmp-4-0"]
    assert ckpt.latest_step(str(tmp_path)) == jax_ckpt.latest_step(str(tmp_path)) == 2
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_a_port_fit_restores_in_jax_and_a_jax_fit_in_the_port(tmp_path, mesh11):
    """The loop's own checkpoints across the packages: the port's
    {params, opt} after 2 AdamW steps restored by JAX onto JAX's tree, and
    JAX's restored by the port and trained on by its ``fit``."""
    jcfg = jax_get_reduced("qwen3-4b")
    jmodel = jax_get_model(jcfg)
    cfg = get_reduced("qwen3-4b")
    model = get_model(cfg, device="cpu")
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")

    params, _ = fit(model, lm_batch_fn(cfg, 100, 16, 2, device="cpu"), steps=2,
                    ckpt_dir=port_dir, ckpt_every=2)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    template = {"params": jparams,
                "opt": jax.tree.map(jnp.asarray, {"m": jparams, "v": jparams})}
    got = jax_ckpt.restore(port_dir, 2, template)
    for (p, a), (_, b) in zip(leaves(jax.tree.map(np.asarray, got["params"])),
                              leaves(params)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=p)

    with compat.set_mesh(mesh11):
        jp, _ = jax_loop.fit(jmodel, jax_loop.lm_batch_fn(jcfg, 100, 16, 2), steps=2,
                             ckpt_dir=jax_dir, ckpt_every=2)
    masters = model.init(0, masters=True)
    back = ckpt.restore(jax_dir, 2, {"params": masters, "opt": adamw().init(masters)},
                        device="cpu")
    for (p, a), (_, b) in zip(leaves(back["params"]), leaves(jax.tree.map(np.asarray, jp))):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b, err_msg=p)
    _, losses = fit(model, lm_batch_fn(cfg, 100, 16, 2, device="cpu"), steps=3,
                    ckpt_dir=jax_dir, ckpt_every=2)
    assert len(losses) == 1 and np.isfinite(losses[0])
