"""The port's rwkv6, RG-LRU hybrid and whisper training on a ``("data",
"model")`` device mesh against the JAX package's jitted step on a mesh of
the same shape, on the CPU.

The harness is ``tests/test_torch_lm_mesh_train.py``'s: JAX runs the body
of its ``make_train_step`` (``jax.value_and_grad`` of ``train_loss(params,
batch, dp)``, then AdamW's ``update``) jitted with ``in_shardings`` of
``param_specs``, the optimizer's ``state_specs`` and the batch's
``P(dp)`` (whisper's frames too) on conftest's 4 host devices, one
compile an (arch, mesh) run twice: step 1 from ``init``'s weights with
their constant entries redrawn (``test_torch_lm_train.redraw_constants``),
step 2 from step 1's weights and state on another batch.  rwkv6 and the
hybrid are compiled with ``xla_allow_excess_precision`` off, as
``tests/test_torch_lm_train.py`` compiles them (JAX's bf16 casts as
written).  One 4-rank gloo world, spawned once for the module, runs step 2
on every rank from JAX's step-1 weights and state (``params_from_jax`` and
``state_from_jax`` with ``mesh=``).

Bounds, each family's from its one-device test
(``tests/test_torch_lm_train.py``): the loss within ``LOSS_ATOL`` = 0.01
of JAX's, each leaf's gradient within
``GRAD_REL`` (0.16 for rwkv6 and the hybrid, 0.08 for whisper) of JAX's in
relative L2 over every rank's shard against the same block of JAX's whole
leaf; AdamW on JAX's own step-2 gradients within the float32 bounds of the
unmeshed optimizer test; (1, 1) the unmeshed step to the bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import compat
from repro.configs import get_reduced as jax_get_reduced
from repro.models.registry import get_model as jax_get_model
from repro.train.optimizer import get_optimizer as jax_get_optimizer

from repro_torch.configs import get_reduced
from repro_torch.gbdt.distributed import run_ranks
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import get_model, params_from_jax, state_from_jax
from repro_torch.models.base import shard
from repro_torch.train.loop import make_train_step, state_layout
from repro_torch.train.optimizer import get_optimizer, tree_map

from test_torch_lm_mesh_train import (
    OPT_ATOL,
    OPT_RTOL,
    _Coords,
    _host,
    _jmesh,
    _rel,
    _spec_leaves,
    _specs,
    _to_jax,
    _to_port,
)
from test_torch_lm_train import NO_EXCESS, leaves, redraw_constants

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 host devices (see conftest XLA_FLAGS)"
)

WORLD = 4
MESHES = [(2, 2), (1, 4)]
ARCHS = ["rwkv6-1.6b", "recurrentgemma-9b", "whisper-small"]
AS_WRITTEN = ("rwkv", "hybrid")  # compiled with excess precision off
B, S = 4, 16
LOSS_ATOL = 0.01
GRAD_REL = {"rwkv": 0.16, "hybrid": 0.16, "encdec": 0.08}


def _batch(cfg, seed):
    """Tokens and labels (B, S), whisper's frames (B, S // 2, D), drawn
    with numpy; a few labels -1."""
    rng = np.random.default_rng(3000 + seed)
    batch = {}
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, S // cfg.frontend_len_div, cfg.d_model))
        batch["frames"] = frames.astype(np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels[0, :3] = -1
    batch["labels"] = labels
    return batch


def jax_case(name, shape) -> dict:
    """JAX's two steps on ``shape``: step 1's weights and state (host), and
    step 2's loss, gradients, weights and state, with step 2's batch."""
    cfg = jax_get_reduced(name)
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
    with compat.set_mesh(mesh):
        p = jax.tree.map(jnp.asarray, params)
        args = jax.device_put((p, opt.init(p), jnp.asarray(0, jnp.int32),
                               _to_jax(batches[0])), shardings)
        fn = jax.jit(step, in_shardings=shardings)
        if cfg.family in AS_WRITTEN:
            fn = fn.lower(*args).compile(compiler_options=NO_EXCESS)
        _, _, p1, s1 = fn(*args)
        args = jax.device_put((p1, s1, jnp.asarray(1, jnp.int32), _to_jax(batches[1])),
                              shardings)
        loss, g, p2, s2 = fn(*args)
    return {"p1": _host(p1), "s1": _host(s1), "loss": float(loss), "grads": _host(g),
            "p2": _host(p2), "s2": _host(s2), "batch": batches[1]}


# --------------------------------------------------------------------------
# the port's world
# --------------------------------------------------------------------------


def _port_step(cfg, mesh, case) -> dict:
    """Step 2 on this rank from JAX's step-1 weights and state: the loss,
    the gradients (host float32), and the weights and state AdamW leaves
    from JAX's step-2 gradients (this rank's shards)."""
    model = get_model(cfg, device="cpu")
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    params = params_from_jax(cfg, case["p1"], device="cpu", masters=True, mesh=mesh)
    state = state_from_jax(cfg, case["s1"], device="cpu", mesh=mesh)
    loss, grads = make_train_step(model, opt, mesh).grads(params, _to_port(case["batch"]))
    jax_grads = params_from_jax(cfg, case["grads"], device="cpu", masters=True, mesh=mesh)
    step = torch.tensor(1, dtype=torch.int32)
    if mesh is None:
        opt.update(jax_grads, state, params, step)
    else:
        specs, shapes = state_layout(cfg, opt)
        opt.update(jax_grads, state, params, step, mesh=mesh, specs=specs["params"],
                   shapes=shapes["params"])
    host = lambda tree: tree_map(lambda t: t.numpy().copy(), tree)  # noqa: E731
    return {"loss": float(loss), "grads": host(grads), "p2": host(params), "s2": host(state)}


def _world(rank, device, cases):
    meshes = {shape: RankMesh(shape, device_type="cpu") for shape in MESHES + [(1, 1)]}
    out = {"coords": {shape: m.coords for shape, m in meshes.items()}}
    for (name, shape), case in cases.items():
        cfg = get_reduced(name)
        out["step", name, shape] = _port_step(cfg, meshes[shape], case)
        if shape == (2, 2) and meshes[(1, 1)].member:  # rank 0: (1, 1) against no mesh
            out["one", name] = [_port_step(cfg, m, case) for m in (meshes[(1, 1)], None)]
        if shape == (2, 2):
            out["refused", name] = _refusals(cfg, meshes[shape], case)
    return out


def _refusals(cfg, mesh, case) -> dict:
    """The messages of a meshed ``train_loss`` given 3 rows, and given
    ``dp=None``."""
    model = get_model(cfg, device="cpu")
    params = params_from_jax(cfg, case["p1"], device="cpu", masters=True, mesh=mesh)
    batch = _to_port(case["batch"])
    out = {}
    for what, b, dp in (("rows", {k: t[:3] for k, t in batch.items()}, ("data",)),
                        ("whole", batch, None)):
        try:
            model.train_loss(params, b, mesh=mesh, dp=dp)
            out[what] = "no error"
        except ValueError as e:
            out[what] = str(e)
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


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", ARCHS)
def test_meshed_loss_and_gradients_match_jax(world, cases, name, shape):
    """Every rank's loss is the global batch's, and its gradient shards
    JAX's at the family's bound."""
    case = cases[name, shape]
    for r in world:
        assert abs(r["step", name, shape]["loss"] - case["loss"]) <= LOSS_ATOL
    rel = _rel(world, ("step", name, shape), shape, case["grads"], lambda r, _: r["grads"],
               _specs(name, shape))
    bound = GRAD_REL[get_reduced(name).family]
    assert max(rel.values()) <= bound, sorted(rel.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", ARCHS)
def test_meshed_optimizer_update_matches_jax(world, cases, name, shape):
    """AdamW on every rank's shards, from JAX's step-1 weights and state and
    JAX's step-2 gradients: the weights and state it leaves equal JAX's
    step 2 within the unmeshed optimizer test's float32 bounds."""
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


@pytest.mark.parametrize("name", ARCHS)
def test_one_rank_on_each_axis_is_the_unmeshed_step_to_the_bit(world, name):
    meshed, unmeshed = world[0]["one", name]
    assert meshed["loss"] == unmeshed["loss"]
    for key in ("grads", "p2", "s2"):
        for (path, a), (_, b) in zip(leaves(meshed[key]), leaves(unmeshed[key])):
            assert np.array_equal(a, b), (key, path)


@pytest.mark.parametrize("entry", ["ln_x", "ln_x_b"])
def test_rwkv6_groupnorm_gradient_is_summed_over_the_model_axis(world, entry):
    """``ln_x`` and ``ln_x_b`` are whole on every rank, each of which uses
    its block of the heads: on (1, 4) every rank's gradient is the whole
    leaf's, non-zero in the other ranks' blocks too (without the sum over
    ``"model"`` it would be zero outside the rank's own block), and the
    same on all four ranks."""
    got = [dict(leaves(r["step", "rwkv6-1.6b", (1, 4)]["grads"]))[f".layers.{entry}"]
           for r in world]
    D = got[0].shape[-1]
    for r, g in zip(world, got):
        own = r["coords"][(1, 4)]["model"]
        for blk in range(4):
            if blk != own:
                assert np.abs(g[..., blk * D // 4:(blk + 1) * D // 4]).min() > 0, (own, blk)
        np.testing.assert_array_equal(g, got[0])


@pytest.mark.parametrize("name", ARCHS)
def test_a_meshed_step_refuses_a_batch_it_cannot_split(world, name):
    """Through ``registry.get_model`` every family trains on a mesh (the
    steps above), and refuses, as the transformer does, a batch that the
    data axes do not divide or a ``dp`` that leaves a data axis whole."""
    got = world[0]["refused", name]
    assert "does not divide over the 2 shards" in got["rows"]
    assert "leaves it whole over ['data']" in got["whole"]
