"""The port's transformer-family training on a ``("data", "model")`` device
mesh against the JAX package's jitted step on a mesh of the same shape, on
the CPU.

JAX runs the body of its ``make_train_step`` (``jax.value_and_grad`` of
``train_loss(params, batch, dp)``, then the optimizer's ``update``) jitted
with ``in_shardings`` of ``param_specs``, the optimizer's ``state_specs``
and the batch's ``P(dp)``, as its dry run compiles the step, on conftest's
4 host devices: one compile an (arch, mesh) for the module, run twice.
Step 1 starts from ``init``'s weights with their constant entries redrawn
(``test_torch_lm_train.redraw_constants``: no gradient trivially zero) and
a zero state; step 2 from step 1's weights and state, on another batch.
One 4-rank gloo world (``run_ranks(..., device="cpu")``), spawned once for
the module, runs step 2 on every rank of the port's mesh from JAX's step-1
weights and state (``params_from_jax`` and ``state_from_jax`` with
``mesh=``), so each comparison is one step from the same point: AdamW's
``m``/``v`` and Adafactor's ``vr``/``vc``/``v`` already non-zero.

Reduced qwen3-4b (dense), olmoe-1b-7b (MoE), llava-next-34b (VLM) and
llama4-maverick (MoE every other layer, Adafactor) on (2, 2) and (1, 4).
The reduced configs pad their heads for a 2-way ``"model"`` axis; on
(1, 4) llama4's 6 padded heads do not split over 4 ranks (the port
refuses a split head), so there both packages take the config with
``model_axis=4``, padded to 8 heads as production pads for 16.

Routing is discontinuous (``test_torch_lm_train`` says why), and on a
mesh each data shard routes its own tokens under its own capacity, so the
MoE configs run on JAX's routes: JAX's ``_moe_local`` records them from
inside its ``shard_map`` (``jax.debug.callback`` with the device's
coordinates) and each rank of the port takes its data shard's
(``chip_smoke.moe_routes``).

Bounds, ``tests/test_torch_lm_train.py``'s for the transformer family: the
loss within ``LOSS_ATOL`` = 0.01 of JAX's and each leaf's gradient within
``GRAD_REL`` = 0.08 of JAX's in relative L2, over every rank's shard against the same block of
JAX's whole leaf (each shard weighs alike).  The optimizer is held on
JAX's own step-2 gradients, so that what it adds is measured alone: the
weights and state it leaves on every rank within the unmeshed optimizer
test's float32 bounds (rtol 1e-6, atol 1e-7) of JAX's, cut to the rank.
(AdamW divides by ``sqrt(v)``, so gradients within 0.08 of each other
can still update by very different amounts where a gradient is rounding
noise, as JAX's bf16 sum of embedding rows is.)  (1, 1) is the unmeshed
step to the bit, and an uneven Adafactor split updates every rank's shard
as the whole leaf's update cut to it, its padding zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import repro.models.layers as jax_layers
from repro import compat
from repro.configs import get_reduced as jax_get_reduced
from repro.models.registry import get_model as jax_get_model
from repro.train.optimizer import get_optimizer as jax_get_optimizer

from repro_torch.configs import get_reduced
from repro_torch.gbdt.distributed import run_ranks
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import get_model, params_from_jax, state_from_jax
from repro_torch.models.base import shard
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import adafactor, get_optimizer, tree_map

from test_torch_lm_train import leaves, moe_routes, redraw_constants

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 host devices (see conftest XLA_FLAGS)"
)

WORLD = 4
MESHES = [(2, 2), (1, 4)]
ARCHS = ["qwen3-4b", "olmoe-1b-7b", "llava-next-34b", "llama4-maverick-400b-a17b"]
B, S = 4, 16
LOSS_ATOL = 0.01
GRAD_REL = 0.08
NOISE = 1e-6
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7


def _replace(name, shape) -> dict:
    """The config fields both packages change for ``shape``: a 4-way
    ``"model"`` axis pads the heads for 4 where the reduced config's do not
    split."""
    cfg = get_reduced(name)
    return {} if cfg.n_heads_padded % shape[1] == 0 else {"model_axis": shape[1]}


def _jmesh(shape):
    return compat.make_mesh(shape, ("data", "model"))


def _batch(cfg, seed):
    """Tokens and labels (B, S) (a VLM: its patch embeddings first, their
    labels -1), drawn with numpy."""
    rng = np.random.default_rng(2000 + seed)
    batch, n_text = {}, S
    if cfg.family == "vlm":
        pe = S // cfg.frontend_len_div
        batch["embeds"] = rng.normal(size=(B, pe, cfg.d_model)).astype(np.float32)
        n_text = S - pe
    batch["tokens"] = rng.integers(0, cfg.vocab, size=(B, n_text)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    if cfg.family == "vlm":
        labels[:, :pe] = -1
    batch["labels"] = labels
    return batch


def _to_jax(batch):
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else jnp.int32)
            for k, v in batch.items()}


def _to_port(batch):
    return {k: torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _recording(store: dict):
    """JAX's ``_moe_local`` that also records, from inside its
    ``shard_map``, the experts it routes each local token to, by the
    device's (data, model) coordinates, in call order."""
    real = jax_layers._moe_local

    def record(e, d, m):
        store.setdefault((int(d), int(m)), []).append(np.asarray(e))

    def recording(x, w_router, *args, top_k, **kw):
        logits = jnp.einsum("nd,de->ne", x.reshape(-1, x.shape[-1]),
                            w_router.astype(x.dtype)).astype(jnp.float32)
        _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
        jax.debug.callback(record, top_e, jax.lax.axis_index("data"),
                           jax.lax.axis_index("model"))
        return real(x, w_router, *args, top_k=top_k, **kw)

    return recording


def jax_case(name, shape) -> dict:
    """JAX's two steps on ``shape``: step 1's weights and state (host), and
    step 2's loss, gradients, weights and state, with both batches, and
    for an MoE config step 2's forward routes a data shard (a list of
    (N_loc, k) arrays in layer order, the same on every ``"model"`` rank)."""
    cfg = dataclasses.replace(jax_get_reduced(name), **_replace(name, shape))
    model = jax_get_model(cfg)
    opt = jax_get_optimizer(cfg.optimizer, cfg.learning_rate)
    mesh = _jmesh(shape)
    pshapes, pspecs = model.abstract_init()
    ospecs = opt.state_specs(pspecs, pshapes)
    params = redraw_constants(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0))),
                              np.random.default_rng(0))
    batches = [_batch(cfg, 0), _batch(cfg, 1)]
    dp = ("data",)
    bspecs = {k: P(dp, *([None] * (v.ndim - 1))) for k, v in batches[0].items()}
    nsh = lambda spec: jax.tree.map(lambda s: NamedSharding(mesh, s), spec,  # noqa: E731
                                    is_leaf=lambda x: isinstance(x, P))

    def step(p, s, t, b):
        loss, g = jax.value_and_grad(lambda p: model.train_loss(p, b, dp))(p)
        new_p, new_s = opt.update(g, s, p, t)
        return loss, g, new_p, new_s

    shardings = (nsh(pspecs), nsh(ospecs), NamedSharding(mesh, P()), nsh(bspecs))
    store, real = {}, jax_layers._moe_local
    jax_layers._moe_local = _recording(store)
    try:
        with compat.set_mesh(mesh):
            fn = jax.jit(step, in_shardings=shardings)
            run = lambda *args: fn(*jax.device_put(args, shardings))  # noqa: E731
            p = jax.tree.map(jnp.asarray, params)
            _, _, p1, s1 = run(p, opt.init(p), jnp.asarray(0, jnp.int32), _to_jax(batches[0]))
            jax.effects_barrier()
            store.clear()
            loss, g, p2, s2 = run(p1, s1, jnp.asarray(1, jnp.int32), _to_jax(batches[1]))
            jax.effects_barrier()
    finally:
        jax_layers._moe_local = real
    n_moe = sum(t.shape[0] for path, t in leaves(params) if path.endswith(".router"))
    routes = {}
    for (d, m), seen in store.items():  # the forward's calls come first
        routes.setdefault(d, seen[:n_moe])
        assert all(np.array_equal(a, b) for a, b in zip(routes[d], seen[:n_moe]))
    return {"p1": _host(p1), "s1": _host(s1), "loss": float(loss), "grads": _host(g),
            "p2": _host(p2), "s2": _host(s2), "batch": batches[1], "routes": routes}


# --------------------------------------------------------------------------
# the port's world
# --------------------------------------------------------------------------


def _port_step(cfg, mesh, case, forced: bool = True) -> dict:
    """Step 2 on this rank from JAX's step-1 weights and state: the loss,
    the gradients (host float32), and the weights and state that the
    optimizer leaves from JAX's step-2 gradients (this rank's shards).
    ``forced``: an MoE layer takes the experts JAX routed this rank's data
    shard to."""
    model = get_model(cfg, device="cpu")
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    params = params_from_jax(cfg, case["p1"], device="cpu", masters=True, mesh=mesh)
    state = state_from_jax(cfg, case["s1"], device="cpu", mesh=mesh)
    train_step = make_train_step(model, opt, mesh)
    routes = case["routes"].get(0 if mesh is None else mesh.coords["data"], []) if forced else []
    with moe_routes(list(routes)):
        loss, grads = train_step.grads(params, _to_port(case["batch"]))
    jax_grads = params_from_jax(cfg, case["grads"], device="cpu", masters=True, mesh=mesh)
    step = torch.tensor(1, dtype=torch.int32)
    if mesh is None:
        opt.update(jax_grads, state, params, step)
    else:
        from repro_torch.train.loop import state_layout

        specs, shapes = state_layout(cfg, opt)
        opt.update(jax_grads, state, params, step, mesh=mesh, specs=specs["params"],
                   shapes=shapes["params"])
    host = lambda tree: tree_map(lambda t: t.numpy().copy(), tree)  # noqa: E731
    return {"loss": float(loss), "grads": host(grads), "p2": host(params),
            "s2": host(state)}


def _uneven(mesh) -> dict:
    """Adafactor on a (5, 10) leaf split (``"data"``, ``"model"``) and a
    (10,) leaf split over ``"model"``: this rank's updated shards and
    state, from shards of seeded whole tensors."""
    rng = np.random.default_rng(7)
    specs = {"w": ("data", "model"), "b": ("model",)}
    shapes = {"w": (5, 10), "b": (10,)}
    p = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    g = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    opt = adafactor(lr=0.1)
    p = {k: shard(t, specs[k], mesh) for k, t in p.items()}
    g = {k: shard(t, specs[k], mesh) for k, t in g.items()}
    state = opt.init(p)
    for t in range(2):
        opt.update(g, state, p, torch.tensor(t, dtype=torch.int32), mesh=mesh, specs=specs,
                   shapes=shapes)
    return {"p": {k: t.numpy() for k, t in p.items()},
            "s": tree_map(lambda t: t.numpy(), state)}


def _world(rank, device, cases):
    meshes = {shape: RankMesh(shape, device_type="cpu") for shape in MESHES + [(1, 1)]}
    out = {"coords": {shape: m.coords for shape, m in meshes.items()}}
    for (name, shape), case in cases.items():
        mesh = meshes[shape]
        cfg = dataclasses.replace(get_reduced(name), **_replace(name, shape))
        out["step", name, shape] = _port_step(cfg, mesh, case)
        if shape == (2, 2) and name in ("qwen3-4b", "llama4-maverick-400b-a17b"):
            if meshes[(1, 1)].member:  # rank 0: (1, 1) against no mesh, own routes
                out["one", name] = [_port_step(cfg, m, case, forced=False)
                                    for m in (meshes[(1, 1)], None)]
    for shape in MESHES:
        out["uneven", shape] = _uneven(meshes[shape])
    return out


@pytest.fixture(scope="module")
def cases():
    return {(name, shape): jax_case(name, shape) for name in ARCHS for shape in MESHES}


@pytest.fixture(scope="module")
def world(cases):
    return run_ranks(_world, WORLD, cases, device="cpu")


# --------------------------------------------------------------------------
# the comparisons
# --------------------------------------------------------------------------


class _Coords:
    """A rank's coordinates on a mesh (``base.shard`` needs no group)."""

    def __init__(self, shape, coords):
        self.axis_names, self.sizes, self.coords = ("data", "model"), shape, coords

    shape = RankMesh.shape

    def axis_size(self, a):
        return self.shape[a]

    def axis_index(self, a):
        return self.coords[a]


def _spec_leaves(tree, path=""):
    """(path, sharding) as ``leaves`` names paths, a sharding tuple a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rel(world, key, shape, want, get, specs) -> dict:
    """Relative L2 a leaf of every rank's shards (``get(rank's result,
    its coordinates)``) against the same blocks of JAX's whole leaves
    ``want``."""
    spec_of = dict(_spec_leaves(specs))
    num, den = {}, {}
    for r in world:
        mesh = _Coords(shape, r["coords"][shape])
        got = dict(leaves(get(r[key], mesh)))
        for path, w in leaves(want):
            w = shard(torch.from_numpy(np.array(w)), spec_of[path], mesh).numpy()
            g = got[path]
            assert g.shape == w.shape, (path, g.shape, w.shape)
            num[path] = num.get(path, 0.0) + float(np.sum((g - w) ** 2))
            den[path] = den.get(path, 0.0) + float(np.sum(w ** 2))
    return {p: (num[p] / den[p]) ** 0.5 if den[p] else num[p] ** 0.5 for p in num}


def _specs(name, shape, tree="params"):
    from repro_torch.train.loop import state_layout

    cfg = dataclasses.replace(get_reduced(name), **_replace(name, shape))
    specs = state_layout(cfg, get_optimizer(cfg.optimizer, cfg.learning_rate))[0]
    return specs[tree]


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", ARCHS)
def test_meshed_loss_and_gradients_match_jax(world, cases, name, shape):
    """Every rank's loss is the global batch's, and its gradient shards
    JAX's, the MoE configs on JAX's routes.  llama4's router is top-1 (the
    renormalised weight p / p is 1): its true gradient is 0 and both
    packages return rounding noise, held below ``NOISE`` of the largest
    gradient, as ``test_torch_lm_train`` holds it."""
    case = cases[name, shape]
    for r in world:
        assert abs(r["step", name, shape]["loss"] - case["loss"]) <= LOSS_ATOL
    rel = _rel(world, ("step", name, shape), shape, case["grads"], lambda r, _: r["grads"],
               _specs(name, shape))
    if get_reduced(name).top_k == 1:
        top = max(np.abs(g).max() for _, g in leaves(case["grads"]))
        for path in [p for p in rel if p.endswith(".router")]:
            del rel[path]
            assert np.abs(dict(leaves(case["grads"]))[path]).max() <= NOISE * top
            for r in world:
                got = dict(leaves(r["step", name, shape]["grads"]))[path]
                assert np.abs(got).max() <= NOISE * top, path
    assert max(rel.values()) <= GRAD_REL, sorted(rel.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", ARCHS)
def test_meshed_optimizer_update_matches_jax(world, cases, name, shape):
    """The optimizer on every rank's shards (AdamW; Adafactor for llama4),
    from JAX's step-1 weights and state and JAX's step-2 gradients: the
    weights and state it leaves equal JAX's step 2 within the unmeshed
    optimizer test's float32 bounds (``test_torch_train_loop``)."""
    case = cases[name, shape]
    for key, specs in (("p2", _specs(name, shape)), ("s2", _specs(name, shape, "opt"))):
        spec_of = dict(_spec_leaves(specs))
        for r in world:
            mesh = _Coords(shape, r["coords"][shape])
            got = dict(leaves(r["step", name, shape][key]))
            for path, w in leaves(case[key]):
                w = shard(torch.from_numpy(np.array(w)), spec_of[path], mesh).numpy()
                np.testing.assert_allclose(got[path], w, rtol=OPT_RTOL, atol=OPT_ATOL,
                                           err_msg=f"{key}{path} at {mesh.coords}")


@pytest.mark.parametrize("name", ["qwen3-4b", "llama4-maverick-400b-a17b"])
def test_one_rank_on_each_axis_is_the_unmeshed_step_to_the_bit(world, name):
    meshed, unmeshed = world[0]["one", name]
    assert meshed["loss"] == unmeshed["loss"]
    for key in ("grads", "p2", "s2"):
        for (path, a), (_, b) in zip(leaves(meshed[key]), leaves(unmeshed[key])):
            assert np.array_equal(a, b), (key, path)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_an_uneven_adafactor_split_does_not_count_its_padding(world, shape):
    """Two Adafactor steps on shards of leaves the mesh splits unevenly (5
    rows over 2, 10 columns over 4) equal the unmeshed steps' results cut
    to each rank, the padding zero in the weights and in ``vr``/``vc``/``v``
    (``g * g + eps`` would make it count, and non-zero)."""
    rng = np.random.default_rng(7)
    shapes = {"w": (5, 10), "b": (10,)}
    specs = {"w": ("data", "model"), "b": ("model",)}
    p = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    g = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    opt = adafactor(lr=0.1)
    state = opt.init(p)
    for t in range(2):
        opt.update(g, state, p, torch.tensor(t, dtype=torch.int32))
    state_specs = opt.state_specs(specs, shapes)
    for r in world:
        mesh = _Coords(shape, r["coords"][shape])
        got = r["uneven", shape]
        for k in shapes:
            np.testing.assert_allclose(got["p"][k], shard(p[k], specs[k], mesh).numpy(),
                                       rtol=1e-6, atol=1e-7)
            for n, want in state[k].items():
                w = shard(want, state_specs[k][n], mesh).numpy()
                np.testing.assert_allclose(got["s"][k][n], w, rtol=1e-5, atol=0)
                assert np.array_equal(got["s"][k][n] == 0, w == 0), (k, n)
