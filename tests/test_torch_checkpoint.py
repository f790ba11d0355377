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
from jax.sharding import NamedSharding, PartitionSpec as P

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


# --------------------------------------------------------------------------
# checkpoints on a device mesh: one 4-rank gloo world for the module
# --------------------------------------------------------------------------


def _mesh_tree():
    """Reduced llama4-maverick's {params, opt}: JAX's ``init`` weights and an
    Adafactor state of seeded positive values (``vr``/``vc``/``v``), with
    an ``extra`` leaf that the meshes split unevenly (5 rows over 2, 10
    columns over 4); its shardings (``state_layout``'s) and whole shapes."""
    from repro_torch.train.loop import state_layout
    from repro_torch.train.optimizer import get_optimizer

    cfg = get_reduced("llama4-maverick-400b-a17b")
    specs, shapes = state_layout(cfg, get_optimizer(cfg.optimizer))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jax_get_model(jax_get_reduced(cfg.name)).init(jax.random.PRNGKey(0)))
    opt = _map_shapes(lambda s: rng.random(s).astype(np.float32), shapes["opt"])
    tree = {"params": params, "opt": opt,
            "extra": rng.normal(size=(5, 10)).astype(np.float32)}
    specs = {**specs, "extra": ("data", "model")}
    shapes = {**shapes, "extra": (5, 10)}
    return tree, specs, shapes


def _map_shapes(fn, shapes):
    if isinstance(shapes, dict):
        return {k: _map_shapes(fn, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_map_shapes(fn, v) for v in shapes]
    return fn(shapes)


def _ckpt_world(rank, device, tree, specs, shapes, port_dir, jax_dir, fit_dirs):
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models.base import map_leaves, shard

    meshes = {s: RankMesh(s, device_type="cpu") for s in ((2, 2), (1, 4))}
    m22 = meshes[(2, 2)]
    host = lambda t: _map(lambda x: x.numpy().copy(), t)  # noqa: E731
    shards = map_leaves(lambda _, a, spec: shard(torch.from_numpy(a), spec, m22), tree, specs)
    path = ckpt.save(port_dir, 5, shards, mesh=m22, specs=specs, shapes=shapes)
    out = {"coords": {s: m.coords for s, m in meshes.items()}, "path": path,
           "saved": host(shards),
           "port_onto_14": host(ckpt.restore(port_dir, 5, shards, "cpu", mesh=meshes[(1, 4)],
                                             specs=specs)),
           "port_onto_22": host(ckpt.restore(port_dir, 5, shards, "cpu", mesh=m22,
                                             specs=specs)),
           "jax_onto_22": host(ckpt.restore(jax_dir, 6, shards, "cpu", mesh=m22, specs=specs))}
    # the restart-exact loop on (2, 2): 3 steps, against 2, a crash, and a resume
    cfg = get_reduced("qwen3-4b")
    model = get_model(cfg, device="cpu")
    batches = lm_batch_fn(cfg, 100, 16, 4, device="cpu")
    whole, _ = fit(model, batches, steps=3, mesh=m22)
    fit(model, batches, steps=2, ckpt_dir=fit_dirs, ckpt_every=2, mesh=m22)
    resumed, losses = fit(model, batches, steps=3, ckpt_dir=fit_dirs, ckpt_every=2, mesh=m22)
    out["resume"] = (host(whole), host(resumed), losses)
    return out


@pytest.fixture(scope="module")
def mesh_ckpt(tmp_path_factory):
    from repro_torch.gbdt.distributed import run_ranks

    tree, specs, shapes = _mesh_tree()
    root = tmp_path_factory.mktemp("mesh_ckpt")
    jax_dir = str(root / "jax")
    jax_ckpt.save(jax_dir, 6, jax.tree.map(jnp.asarray, tree))
    ranks = run_ranks(_ckpt_world, 4, tree, specs, shapes, str(root / "port"), jax_dir,
                      str(root / "fit"), device="cpu")
    return {"tree": tree, "specs": specs, "ranks": ranks, "port_dir": str(root / "port")}


def _device_put_shard(a, spec, shape, coords):
    """The block ``jax.device_put(a, NamedSharding(mesh, P(*spec)))`` puts on
    the device at ``coords`` of a ``shape`` mesh; ``base.shard``'s padded
    block where XLA's ``device_put`` refuses the uneven split."""
    from repro_torch.models.base import shard

    mesh = compat.make_mesh(shape, ("data", "model"))
    try:
        placed = jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))
    except ValueError:
        return shard(torch.from_numpy(a), spec, _Coords(shape, coords)).numpy()
    dev = mesh.devices[coords["data"], coords["model"]]
    (block,) = [s.data for s in placed.addressable_shards if s.device == dev]
    return np.asarray(block)


class _Coords:
    def __init__(self, shape, coords):
        self.axis_names, self.sizes, self.coords = ("data", "model"), shape, coords

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.sizes))

    def axis_size(self, a):
        return self.shape[a]

    def axis_index(self, a):
        return self.coords[a]


def _spec_paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_paths(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_paths(v, f"{path}[{i}]")
    else:
        yield path, tree


def test_a_meshed_save_is_one_file_of_whole_leaves_that_jax_restores_onto_2x2(mesh_ckpt):
    """Rank 0 of the (2, 2) mesh wrote ``shard-0.mpz`` and the manifest,
    renamed in one step, every record a whole leaf; JAX's ``restore(...,
    shardings=)`` places them on its own 2x2 mesh, equal to the leaves."""
    tree, specs = mesh_ckpt["tree"], mesh_ckpt["specs"]
    path = mesh_ckpt["ranks"][0]["path"]
    assert {r["path"] for r in mesh_ckpt["ranks"]} == {path}
    assert sorted(os.listdir(mesh_ckpt["port_dir"])) == ["step-5"]
    assert sorted(os.listdir(path)) == ["manifest.json", "shard-0.mpz"]
    spec_of = dict(_spec_paths(specs))
    mesh = compat.make_mesh((2, 2), ("data", "model"))
    # the uneven leaf aside: JAX places only splits that divide
    template = {k: jax.tree.map(jnp.asarray, v) for k, v in tree.items() if k != "extra"}
    paths = [p for p, _ in leaves(template)]
    flat = [NamedSharding(mesh, P(*spec_of[p])) for p in paths]
    shardings = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template), flat)
    got = jax_ckpt.restore(mesh_ckpt["port_dir"], 5, template, shardings)
    for (p, a), (_, b) in zip(leaves(got), leaves(template)):
        assert a.sharding.spec == P(*spec_of[p]), p
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=p)


@pytest.mark.parametrize("what,shape", [("port_onto_14", (1, 4)), ("jax_onto_22", (2, 2))],
                         ids=["port-2x2-save-onto-1x4", "jax-save-onto-2x2"])
def test_a_checkpoint_restores_onto_a_port_mesh_as_jax_device_put_places_it(mesh_ckpt, what,
                                                                            shape):
    """Every rank's restored shard is the block ``jax.device_put`` puts on
    the device at its coordinates (the uneven ``extra`` leaf: the padded
    block), whichever mesh or package wrote the checkpoint."""
    tree, spec_of = mesh_ckpt["tree"], dict(_spec_paths(mesh_ckpt["specs"]))
    for r in mesh_ckpt["ranks"]:
        coords = r["coords"][shape]
        got = dict(leaves(r[what]))
        for p, a in leaves(tree):
            want = _device_put_shard(a, spec_of[p], shape, coords)
            assert got[p].dtype == want.dtype and np.array_equal(got[p], want), (p, coords)


def test_a_meshed_save_restores_the_saved_shards_to_the_bit(mesh_ckpt):
    """Restored onto the mesh that saved it, every rank holds the shards it
    saved, padding included."""
    for r in mesh_ckpt["ranks"]:
        saved, back = dict(leaves(r["saved"])), dict(leaves(r["port_onto_22"]))
        for p, a in saved.items():
            assert np.array_equal(a, back[p]), p


def test_a_meshed_fit_resumes_to_the_bit(mesh_ckpt):
    """Reduced qwen3-4b on (2, 2): 2 steps and a checkpoint, a crash, a
    resume to step 3, against 3 steps uninterrupted: every rank's masters
    equal to the bit."""
    for r in mesh_ckpt["ranks"]:
        whole, resumed, losses = r["resume"]
        assert len(losses) == 1 and np.isfinite(losses[0])
        for (p, a), (_, b) in zip(leaves(whole), leaves(resumed)):
            assert np.array_equal(a, b), p
