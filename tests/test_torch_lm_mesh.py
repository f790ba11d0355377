"""The port's transformer-family serving on a ``("data", "model")`` device
mesh against the JAX package's on a mesh of the same shape, on the CPU.

One 4-rank gloo world (``run_ranks(..., device="cpu")``), spawned once for
the module, runs every case of the port and returns each rank's results;
a mesh smaller than the world, (1, 2) or (1, 1), takes the first ranks.
JAX runs its counterparts on conftest's 4 host devices, each jitted with
its inputs placed by ``param_specs``, ``abstract_cache``'s specs and the
batch's ``P(dp)``.  Inputs and weights are drawn with numpy and cross to
the port through ``params_from_jax(..., mesh=)``.

Bounds:

* ``flash_decode`` in float32 (the unquantized path) and on the int8
  cache: each rank's output within 1e-6 of JAX's at the same mesh,
  relative to the output's largest magnitude (float32 products and sums
  in each framework's own order: 1.6e-7 absolute seen, which is 1.2e-5 of
  an element near zero),
  and each rank's cache shard equal to JAX's shard, at the slots that
  border the ranks' blocks: ``s_loc - 1``, ``s_loc`` and ``Smax - 1``
  (the new token's int8 scale within one float32 ulp: under ``jax.jit``
  XLA turns ``amax / 127`` into a product with the reciprocal, so JAX's
  jitted and eager ``quantize_kv`` differ by that ulp themselves).
* ``moe_block`` in bf16: each rank's output within PR 20's logit bound,
  0.0625, of JAX's; the slots kept on each (data shard, ``"model"`` rank)
  equal to the count that JAX's routes give under the capacity of the
  shard's own tokens (``_keep_ref``, the independent first-``cap`` rule of
  ``tests/test_torch_lm_layers.py``).  On (2, 2) JAX's output leaves its
  (1, 1) output, and the port's does too, by more than that bound: the
  capacity is counted a data shard.
* reduced qwen3-4b and olmoe-1b-7b, prefill and 3 teacher-forced decode
  steps (the same tokens on both sides): logits within 0.0625 of JAX's at
  the same mesh, where JAX's own (2, 2) and (1, 4) logits leave its (1, 1)
  ones by up to 0.041 (dense) and 1.6 (MoE on a split ``"data"``).
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
from repro.launch import dryrun as jax_dryrun
from repro.models import layers as J
from repro.models.registry import get_model as jax_get_model

from repro_torch.configs import get_reduced
from repro_torch.gbdt.distributed import run_ranks
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import layers as L
from repro_torch.models import params_from_jax, transformer as T
from repro_torch.models.base import shard

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 host devices (see conftest XLA_FLAGS)"
)

WORLD = 4
FD_MESHES = [(1, 4), (2, 2), (1, 2)]
MOE_MESHES = [(2, 2), (4, 1), (1, 4)]
LM_MESHES = [(2, 2), (1, 4)]
LM_ARCHS = ["qwen3-4b", "olmoe-1b-7b"]
LOGIT_ATOL = 0.0625
FD_RTOL = 1e-6
# flash_decode: batch, cache slots, head dim
FD_B, FD_SMAX, FD_DH = 4, 16, 16
# the model runs: batch, prompt, cache slots, decode steps
B, S, SMAX, STEPS = 4, 16, 64, 3
# moe_block: batch, tokens a row, width, expert width
MOE_B, MOE_S, MOE_D, MOE_F = 4, 8, 32, 24


def _jmesh(shape):
    return compat.make_mesh(shape, ("data", "model"))


def _block(a: np.ndarray, coords: dict, shape, dims=(0, 1)) -> np.ndarray:
    """The (data, model) block of a global array: ``dims`` are the axes split
    over data and over model (None: whole)."""
    idx = [slice(None)] * a.ndim
    for axis, dim in zip(("data", "model"), dims):
        if dim is not None:
            n = a.shape[dim] // shape[0 if axis == "data" else 1]
            idx[dim] = slice(coords[axis] * n, (coords[axis] + 1) * n)
    return a[tuple(idx)]


# --------------------------------------------------------------------------
# inputs, drawn with numpy
# --------------------------------------------------------------------------


def _heads(name="qwen3-4b"):
    cfg = jax_get_reduced(name)
    return cfg.padded_heads, np.asarray(cfg.head_mask()).reshape(-1)


def _fd_inputs(pos: int, seed: int):
    (kvp, gp), hm = _heads()
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    kc, vc = f(FD_B, FD_SMAX, kvp, FD_DH), f(FD_B, FD_SMAX, kvp, FD_DH)
    kc[:, pos + 1:] = vc[:, pos + 1:] = 0.0
    return dict(q=f(FD_B, kvp * gp, FD_DH), kc=kc, vc=vc, kn=f(FD_B, kvp, FD_DH),
                vn=f(FD_B, kvp, FD_DH), hm=hm.copy(), gp=gp)


def _fd_positions(shape):
    s_loc = FD_SMAX // shape[1]
    return sorted({s_loc - 1, s_loc, FD_SMAX - 1})


def _moe_inputs(seed=3):
    """Normal activations and weights drawn as ``init`` draws them: normal ×
    fan_in^-0.5 (D for the router, w_in and w_gate; F for w_out)."""
    rng = np.random.default_rng(seed)
    E = 8
    f = lambda *s, fan_in=1: (rng.normal(size=s) * fan_in ** -0.5).astype(np.float32)
    return dict(x=f(MOE_B, MOE_S, MOE_D), router=f(MOE_D, E, fan_in=MOE_D),
                w_in=f(E, MOE_D, MOE_F, fan_in=MOE_D), w_gate=f(E, MOE_D, MOE_F, fan_in=MOE_D),
                w_out=f(E, MOE_F, MOE_D, fan_in=MOE_F), kw=dict(top_k=2, capacity_factor=1.25))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _lm_inputs(name):
    cfg = jax_get_reduced(name)
    params = jax.tree.map(np.asarray, jax_get_model(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, size=(STEPS, B)).astype(np.int32)
    return params, tokens, forced


# --------------------------------------------------------------------------
# the port's world: every case on 4 gloo ranks
# --------------------------------------------------------------------------


def _port_flash_decode(mesh, inp, pos, int8, write=True, local=None):
    """One rank's ``flash_decode`` on its shard: (output, cache shards).
    ``local``: a dict to fill with the rank's cache shards before the call."""
    d, m = mesh.coords["data"], mesh.coords["model"]
    b, s = FD_B // mesh.shape["data"], FD_SMAX // mesh.shape["model"]
    rows, slots = slice(d * b, (d + 1) * b), slice(m * s, (m + 1) * s)
    cache = dict(k_cache=inp["kc"], v_cache=inp["vc"])
    if int8:
        kq, ks = L.quantize_kv(torch.from_numpy(inp["kc"]))
        vq, vs = L.quantize_kv(torch.from_numpy(inp["vc"]))
        cache = dict(k_cache=kq.numpy(), v_cache=vq.numpy(), k_scale=ks.numpy(),
                     v_scale=vs.numpy())
    local = {} if local is None else local
    local.update({k: torch.from_numpy(np.ascontiguousarray(v[rows, slots]))
                  for k, v in cache.items()})
    t = lambda a: torch.from_numpy(a[rows])
    out = L.flash_decode(t(inp["q"]), k_new=t(inp["kn"]), v_new=t(inp["vn"]), pos=pos,
                         head_mask=torch.from_numpy(inp["hm"]), group_size=inp["gp"],
                         mesh=mesh, write=write, **local)
    return out.numpy(), {k: v.numpy() for k, v in local.items()}


def _port_lm(name, mesh, params_np, tokens, forced):
    """Prefill and the teacher-forced decode steps on ``mesh``: the rank's
    logits, one array a step, and its MoE stats."""
    cfg = get_reduced(name)
    params = params_from_jax(cfg, params_np, device="cpu", mesh=mesh)
    stats = {}
    logits, cache = T.prefill(cfg, params, {"tokens": torch.from_numpy(tokens).long()},
                              SMAX, stats, mesh=mesh)
    out = [logits.numpy()]
    for tok in forced:
        logits, cache = T.decode_step(cfg, params, cache, torch.from_numpy(tok).long(),
                                      stats, mesh=mesh)
        out.append(logits.numpy())
    return out, {k: int(v) for k, v in stats.items()}


def _world(rank, device, lm):
    out = {}
    meshes = {shape: RankMesh(shape, device_type="cpu") for shape in
              dict.fromkeys(FD_MESHES + MOE_MESHES + LM_MESHES + [(1, 1)])}
    with torch.no_grad():
        for shape in FD_MESHES:
            mesh = meshes[shape]
            if not mesh.member:
                continue
            for int8 in (False, True):
                for pos in _fd_positions(shape):
                    inp = _fd_inputs(pos, seed=pos)
                    out["fd", shape, int8, pos] = _port_flash_decode(mesh, inp, pos, int8)
            # read only (whisper's cross-attention): no slot written
            inp = _fd_inputs(FD_SMAX - 1, seed=1)
            out["fd_read", shape] = _port_flash_decode(mesh, inp, FD_SMAX - 1, False,
                                                       write=False)
            # past the cache: every rank refuses, no cache changes
            inp, local = _fd_inputs(FD_SMAX - 1, seed=0), {}
            try:
                _port_flash_decode(mesh, inp, FD_SMAX, False, local=local)
                out["fd_past", shape] = "no error", None
            except ValueError as e:
                out["fd_past", shape] = str(e), {k: v.numpy() for k, v in local.items()}
        moe = _moe_inputs()
        for shape in MOE_MESHES + [(1, 1)]:
            mesh = meshes[shape]
            if not mesh.member:
                continue
            d, m = mesh.coords["data"], mesh.coords["model"]
            b = MOE_B // shape[0]
            e = moe["w_in"].shape[0] // shape[1]
            stats = {}
            got = L.moe_block(_bf16(moe["x"][d * b:(d + 1) * b]), _bf16(moe["router"]),
                              *(_bf16(moe[w][m * e:(m + 1) * e]) for w in ("w_in", "w_gate",
                                                                            "w_out")),
                              stats=stats, mesh=mesh, **moe["kw"])
            out["moe", shape] = (got.float().numpy(), int(stats["kept"]), int(stats["slots"]))
        for name, (params_np, tokens, forced) in lm.items():
            for shape in LM_MESHES + [(1, 1)]:
                mesh = meshes[shape]
                if mesh.member:
                    out["lm", name, shape] = _port_lm(name, mesh, params_np, tokens, forced)
            if rank == 0:  # the unmeshed path, for the (1, 1) check
                cfg = get_reduced(name)
                params = params_from_jax(cfg, params_np, device="cpu")
                logits, cache = T.prefill(cfg, params, {"tokens": torch.from_numpy(tokens).long()},
                                          SMAX)
                seq = [logits.numpy()]
                for tok in forced:
                    logits, cache = T.decode_step(cfg, params, cache, torch.from_numpy(tok).long())
                    seq.append(logits.numpy())
                out["lm_unmeshed", name] = seq
        cfg = get_reduced("qwen3-4b")
        refusals = {"refuse_batch": ((2, 2), (4, 1), lambda mesh: T.prefill(
            cfg, params, {"tokens": torch.zeros((3, S), dtype=torch.long)}, SMAX, mesh=mesh)),
                    "refuse_smax": ((2, 2), (1, 4), lambda mesh: T.alloc_cache(
                        cfg, B, SMAX + 3, "cpu", mesh=mesh))}
        for key, (*shapes, call) in refusals.items():
            for shape in shapes:
                params = T.init(cfg, 0, "cpu", mesh=meshes[shape])
                try:
                    call(meshes[shape])
                    out[key, shape] = "no error"
                except ValueError as e:
                    out[key, shape] = str(e)
    out["coords"] = {shape: mesh.coords for shape, mesh in meshes.items()}
    import torch.distributed as dist

    mesh = meshes[(2, 2)]
    out["groups"] = {a: dist.get_process_group_ranks(mesh.group(a)) for a in ("data", "model")}
    try:
        RankMesh((3, 2), device_type="cpu")
        out["too_big"] = "no error"
    except ValueError as e:
        out["too_big"] = str(e)
    return out


@pytest.fixture(scope="module")
def lm_inputs():
    return {name: _lm_inputs(name) for name in LM_ARCHS}


@pytest.fixture(scope="module")
def world(lm_inputs):
    return run_ranks(_world, WORLD, lm_inputs, device="cpu")


def _ranks(world, key, shape):
    """(coords, value) of every rank that ran ``key`` on ``shape``."""
    return [(r["coords"][shape], r[key]) for r in world if key in r]


# --------------------------------------------------------------------------
# JAX at the same mesh
# --------------------------------------------------------------------------


def _jax_flash_decode(shape, inp, pos, int8, write=True):
    mesh = _jmesh(shape)
    dp = ("data",)
    kc, vc = jnp.asarray(inp["kc"]), jnp.asarray(inp["vc"])
    extra = {}
    if int8:
        kc, ks = J.quantize_kv(kc)
        vc, vs = J.quantize_kv(vc)
        extra = dict(k_scale=ks, v_scale=vs)
    fn = lambda q, kc, vc, kn, vn, p, **kw: J.flash_decode(
        mesh, dp, q, kc, vc, kn, vn, p, jnp.asarray(inp["hm"]), inp["gp"], write=write, **kw)
    with compat.set_mesh(mesh):
        res = jax.jit(fn)(jnp.asarray(inp["q"]), kc, vc, jnp.asarray(inp["kn"]),
                          jnp.asarray(inp["vn"]), jnp.asarray(pos, jnp.int32), **extra)
    names = ["k_cache", "v_cache"] + (["k_scale", "v_scale"] if int8 else [])
    return np.asarray(res[0]), {n: np.asarray(a) for n, a in zip(names, res[1:])}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", FD_MESHES, ids=str)
def test_flash_decode_on_a_sequence_sharded_cache_matches_jax(world, shape, int8):
    for pos in _fd_positions(shape):
        want, want_cache = _jax_flash_decode(shape, _fd_inputs(pos, seed=pos), pos, int8)
        ranks = _ranks(world, ("fd", shape, int8, pos), shape)
        assert len(ranks) == shape[0] * shape[1]
        for coords, (got, cache) in ranks:
            w = _block(want, coords, shape, dims=(0, None))
            np.testing.assert_allclose(got, w, rtol=0, atol=FD_RTOL * np.abs(w).max())
            for n, a in cache.items():  # this rank's block of JAX's cache
                if n.endswith("scale"):  # jit computes x / 127 as x * (1 / 127)
                    np.testing.assert_array_max_ulp(a, _block(want_cache[n], coords, shape), 1)
                else:
                    np.testing.assert_array_equal(a, _block(want_cache[n], coords, shape))
        owner = pos // (FD_SMAX // shape[1])
        wrote = [c["model"] for c, (_, cache) in ranks
                 if not np.array_equal(cache["k_cache"],
                                       _block(_fd_inputs(pos, pos)["kc"], c, shape))]
        if not int8:  # only the owner's block changed
            assert set(wrote) == {owner}


@pytest.mark.parametrize("shape", FD_MESHES, ids=str)
def test_decode_past_the_cache_is_refused_on_every_rank(world, shape):
    """The port's kept difference (ROADMAP §C): at ``pos == Smax`` every
    rank raises ``ValueError`` and no rank's cache shard changes."""
    inp = _fd_inputs(FD_SMAX - 1, seed=0)
    ranks = _ranks(world, ("fd_past", shape), shape)
    assert len(ranks) == shape[0] * shape[1]
    for coords, (msg, cache) in ranks:
        assert f"pos={FD_SMAX}" in msg and f"{FD_SMAX} slots" in msg
        np.testing.assert_array_equal(cache["k_cache"], _block(inp["kc"], coords, shape))
        np.testing.assert_array_equal(cache["v_cache"], _block(inp["vc"], coords, shape))


@pytest.mark.parametrize("shape", FD_MESHES, ids=str)
def test_flash_decode_read_only_on_a_sharded_cache_matches_jax(world, shape):
    """``write=False`` (a cross-attention cache): every slot up to ``pos``
    attended, none written."""
    pos = FD_SMAX - 1
    inp = _fd_inputs(pos, seed=1)
    want, _ = _jax_flash_decode(shape, inp, pos, False, write=False)
    for coords, (got, cache) in _ranks(world, ("fd_read", shape), shape):
        w = _block(want, coords, shape, dims=(0, None))
        np.testing.assert_allclose(got, w, rtol=0, atol=FD_RTOL * np.abs(w).max())
        np.testing.assert_array_equal(cache["k_cache"], _block(inp["kc"], coords, shape))


def _jax_moe(shape):
    inp = _moe_inputs()
    mesh = _jmesh(shape)
    args = [jnp.asarray(inp[k], jnp.bfloat16) for k in ("x", "router", "w_in", "w_gate", "w_out")]
    specs = [P("data", None, None), P(None, None)] + [P("model", None, None)] * 3
    with compat.set_mesh(mesh):
        put = [jax.device_put(a, NamedSharding(mesh, s)) for a, s in zip(args, specs)]
        out = jax.jit(lambda *a: J.moe_block(*a, **inp["kw"]))(*put)
    return np.asarray(out.astype(jnp.float32))


def _jax_kept(shape) -> dict:
    """Kept slots a (data shard, model rank) from JAX's routes: ``lax.top_k``
    of the router softmax of the shard's tokens, the capacity from the
    shard's own token count, the first ``cap`` slots of each expert kept."""
    inp = _moe_inputs()
    k, cf = inp["kw"]["top_k"], inp["kw"]["capacity_factor"]
    E = inp["router"].shape[1]
    b, e_loc = MOE_B // shape[0], E // shape[1]
    kept = {}
    for d in range(shape[0]):
        x = jnp.asarray(inp["x"][d * b:(d + 1) * b], jnp.bfloat16).reshape(-1, MOE_D)
        logits = jnp.einsum("nd,de->ne", x, jnp.asarray(inp["router"], jnp.bfloat16))
        _, je = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), k)
        je = np.asarray(je)
        keep = _keep_ref(je, int(max(1, cf * k * x.shape[0] / E))).reshape(je.shape)
        for m in range(shape[1]):
            mine = (je >= m * e_loc) & (je < (m + 1) * e_loc)
            kept[d, m] = int((keep & mine).sum())
    return kept


def _keep_ref(top_e: np.ndarray, cap: int) -> np.ndarray:
    """In flat (token, slot) order, the first ``cap`` slots routed to each
    expert are kept."""
    seen, keep = {}, []
    for e in top_e.reshape(-1):
        seen[e] = seen.get(e, 0) + 1
        keep.append(seen[e] <= cap)
    return np.array(keep)


@pytest.mark.parametrize("shape", MOE_MESHES, ids=str)
def test_moe_block_is_expert_parallel_with_per_shard_capacity(world, shape):
    want = _jax_moe(shape)
    kept = _jax_kept(shape)
    ranks = _ranks(world, ("moe", shape), shape)
    assert len(ranks) == shape[0] * shape[1]
    for coords, (got, n_kept, n_slots) in ranks:
        np.testing.assert_allclose(got, _block(want, coords, shape, dims=(0, None)),
                                   atol=LOGIT_ATOL, rtol=0)
        assert n_kept == kept[coords["data"], coords["model"]]
        assert n_slots == MOE_B // shape[0] * MOE_S * 2


def test_moe_on_a_split_data_axis_leaves_the_one_device_result_as_jax_does(world):
    """JAX's (2, 2) output leaves its (1, 1) output (capacity a data
    shard), and the port's (2, 2) leaves the port's (1, 1) as far."""
    jax_gap = np.abs(_jax_moe((2, 2)) - _jax_moe((1, 1))).max()
    ((_, (whole, _, _)),) = _ranks(world, ("moe", (1, 1)), (1, 1))
    port = np.zeros_like(whole)
    for coords, (got, _, _) in _ranks(world, ("moe", (2, 2)), (2, 2)):
        b = MOE_B // 2
        port[coords["data"] * b:(coords["data"] + 1) * b] = got
    port_gap = np.abs(port - whole).max()
    assert jax_gap > LOGIT_ATOL and port_gap > LOGIT_ATOL
    assert abs(port_gap - jax_gap) <= LOGIT_ATOL


def _jax_lm(name, shape, params, tokens, forced):
    cfg = jax_get_reduced(name)
    model = jax_get_model(cfg)
    mesh = _jmesh(shape)
    _, pspecs = model.abstract_init()
    _, cspecs = model.abstract_cache(B, SMAX)
    nsh = lambda spec: jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                                    is_leaf=lambda x: isinstance(x, P))
    with compat.set_mesh(mesh):
        params = jax.device_put(params, nsh(pspecs))
        tok = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("data", None)))
        logits, cache = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}))(params, tok)
        pad = lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, SMAX - S)] + [(0, 0)] * (x.ndim - 3))
        cache = {"layers": [{k: pad(v) for k, v in c.items()} for c in cache["layers"]],
                 "length": cache["length"]}
        cache = jax.device_put(cache, nsh(cspecs))
        step = jax.jit(lambda p, c, t, pos: model.decode_step(mesh, p, c, t, pos))
        out = [np.asarray(logits)]
        for i, t in enumerate(forced):
            logits, cache = step(params, cache, jnp.asarray(t), jnp.asarray(S + i, jnp.int32))
            out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("shape", LM_MESHES, ids=str)
@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_and_decode_on_the_mesh_match_jax(world, lm_inputs, name, shape):
    cfg = get_reduced(name)
    want = _jax_lm(name, shape, *lm_inputs[name])
    ranks = _ranks(world, ("lm", name, shape), shape)
    assert len(ranks) == shape[0] * shape[1]
    for coords, (got, _) in ranks:
        for step, (g, w) in enumerate(zip(got, want)):
            w = _block(w, coords, shape, dims=(0, None))
            assert g.shape == w.shape == (B // shape[0], cfg.padded_vocab)
            gap = np.abs(g[:, :cfg.vocab] - w[:, :cfg.vocab]).max()
            assert gap <= LOGIT_ATOL, (name, shape, coords, step, gap)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_one_rank_on_each_axis_is_the_unmeshed_path_to_the_bit(world, name):
    ((_, (meshed, _)),) = _ranks(world, ("lm", name, (1, 1)), (1, 1))
    unmeshed = world[0]["lm_unmeshed", name]
    for a, b in zip(meshed, unmeshed):
        assert np.array_equal(a, b)


def test_moe_kept_slots_sum_over_the_model_group_per_shard(world):
    """The model run's stats: a data shard's kept count is the sum over its
    ``"model"`` ranks, and the routed slots are the shard's."""
    for shape in LM_MESHES:
        ranks = _ranks(world, ("lm", "olmoe-1b-7b", shape), shape)
        slots = {c["data"]: st["slots"] for c, (_, st) in ranks}
        cfg = get_reduced("olmoe-1b-7b")
        per_row = (S + STEPS) * cfg.top_k * cfg.n_layers
        assert set(slots.values()) == {B // shape[0] * per_row}
        kept = {}
        for c, (_, st) in ranks:
            kept[c["data"]] = kept.get(c["data"], 0) + st["kept"]
        assert all(0 < k <= slots[d] for d, k in kept.items())


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=str)
def test_a_batch_the_data_axis_does_not_divide_is_refused(world, shape):
    ranks = _ranks(world, ("refuse_batch", shape), shape)
    assert len(ranks) == WORLD
    for _, msg in ranks:
        assert "3 rows" in msg and f"{shape[0]} shards" in msg


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
def test_a_cache_the_model_axis_does_not_divide_is_refused(world, shape):
    ranks = _ranks(world, ("refuse_smax", shape), shape)
    assert len(ranks) == WORLD
    for _, msg in ranks:
        assert f"{SMAX + 3} slots" in msg and f"{shape[1]} ranks" in msg


def test_rank_mesh_is_row_major_with_jax_axis_names(world):
    """Rank r of a (2, 2) mesh sits at (r // 2, r % 2), as JAX's
    ``make_mesh`` lays devices out; an axis's group holds the ranks that
    differ from it on that axis alone; a mesh larger than the world is
    refused."""
    for r, out in enumerate(world):
        assert out["coords"][(2, 2)] == {"data": r // 2, "model": r % 2}
        assert out["groups"]["model"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert out["groups"]["data"] == [r % 2, r % 2 + 2]
        assert "at least 6 ranks" in out["too_big"]
    assert world[1]["coords"][(1, 1)] is None  # past the (1, 1) mesh: no coordinates


def test_dry_run_record_of_a_meshed_decode_cell(monkeypatch):
    """``lower_cell`` on the transformer family's decode: per-device
    collectives by kind and peak from the meshed trace; a prefill cell's
    record is meshed too, its collectives counted on rank 0 (reduced
    config, 2x2 production mesh)."""
    from repro_torch import configs
    from repro_torch.launch import input_specs
    from repro_torch.launch.mesh import make_test_mesh

    monkeypatch.setattr(configs, "get_config", get_reduced)
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda multi_pod: make_test_mesh(2, 2))
    monkeypatch.setitem(input_specs.SHAPES, "decode_32k", dict(seq=64, batch=4, kind="decode"))
    monkeypatch.setitem(input_specs.SHAPES, "prefill_32k", dict(seq=16, batch=4, kind="prefill"))
    dec = dryrun.lower_cell("olmoe-1b-7b", "decode_32k", False)
    assert dec["n_chips"] == 4 and "peak_live_bytes_global" not in dec
    assert dec["peak_live_bytes_per_device"] > dec["memory"]["argument_size_in_bytes"]
    coll = dec["collectives_per_device"]
    assert coll["total"] == coll["all-reduce"] + coll["all-gather"] > 0
    pre = dryrun.lower_cell("olmoe-1b-7b", "prefill_32k", False)
    coll = pre["collectives_per_device"]
    assert coll["total"] == coll["all-reduce"] + coll["all-gather"] > 0
    assert "peak_live_bytes_per_device" in pre and "prefill" in pre["collectives_note"]


# --------------------------------------------------------------------------
# weights: the shards of jax.device_put
# --------------------------------------------------------------------------


class _Coords:
    """A stand-in for a rank's ``RankMesh`` (shapes and coordinates only:
    ``base.shard`` issues no collective)."""

    def __init__(self, shape, coords):
        self.axis_names = ("data", "model")
        self.sizes = shape
        self.coords = dict(zip(self.axis_names, coords))

    shape = RankMesh.shape

    def axis_size(self, a):
        return self.shape[a]

    def axis_index(self, a):
        return self.coords[a]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)], ids=str)
@pytest.mark.parametrize("name", LM_ARCHS + ["rwkv6-1.6b", "recurrentgemma-9b", "whisper-small"])
def test_params_from_jax_shards_are_jax_device_puts(lm_inputs, name, shape):
    """Every family's tree: rwkv6's, the hybrid's (float32 entries too) and
    whisper's as the transformer's."""
    cfg = get_reduced(name)
    params = lm_inputs[name][0] if name in lm_inputs else jax.tree.map(
        np.asarray, jax_get_model(jax_get_reduced(name)).init(jax.random.PRNGKey(0)))
    mesh = _jmesh(shape)
    _, pspecs = jax_get_model(jax_get_reduced(name)).abstract_init()
    placed = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                                                 is_leaf=lambda x: isinstance(x, P)))
    devices = mesh.devices
    for d in range(shape[0]):
        for m in range(shape[1]):
            port = params_from_jax(cfg, params, device="cpu", masters=True,
                                   mesh=_Coords(shape, (d, m)))
            dev = devices[d, m]
            for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(placed)[0],
                                    jax.tree.leaves(port)):
                (want,) = [s.data for s in a.addressable_shards if s.device == dev]
                assert np.array_equal(b.numpy(), np.asarray(want)), (path, d, m)


def test_an_uneven_split_is_padded_as_xla_pads_it():
    """10 rows over 4 ranks: blocks of ceil(10 / 4) = 3, the last holding
    one row and two of zeros (``shard_shape``'s rule); JAX's ``device_put``
    refuses the split (XLA pads only inside a program)."""
    a = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    mesh = _jmesh((1, 4))
    with pytest.raises(ValueError, match="divisible by 4"):
        jax.device_put(a, NamedSharding(mesh, P("model", None)))
    blocks = [shard(torch.from_numpy(a), ("model", None), _Coords((1, 4), (0, m))).numpy()
              for m in range(4)]
    assert all(b.shape == (3, 3) for b in blocks)
    np.testing.assert_array_equal(np.concatenate(blocks)[:10], a)
    np.testing.assert_array_equal(blocks[3][1:], 0)


# --------------------------------------------------------------------------
# the dry run's meshed decode against JAX's compiled step
# --------------------------------------------------------------------------


def _flash_shapes(b, h, dh):
    """The flash-decode combine's float32 results: the max and the
    denominator (b, h), the numerator (b, h, dh)."""
    return {(b, h): 4 * b * h, (b, h, dh): 4 * b * h * dh}


def _jax_flash_bytes(hlo: str, b: int, h: int, dh: int) -> int:
    """Bytes of the all-reduces inside JAX's ``flash_decode`` ``shard_map``
    (tuple members too) whose results have the combine's shapes."""
    import re

    want = {f"f32[{','.join(map(str, k))}]": v for k, v in _flash_shapes(b, h, dh).items()}
    total = 0
    for line in hlo.splitlines():
        m = re.match(r"\s*%\S+ = (.*?) all-reduce(-start)?\(", line)
        if m and "shard_map" in line:
            total += sum(want.get(t, 0) for t in re.findall(r"f32\[[\d,]+\]", m.group(1)))
    return total


def test_dry_run_decode_collectives_beside_jax_parse_collectives():
    """Reduced qwen3-4b, one decode step, B 4, a 64-slot cache, on 2x2:
    the port traced on rank 0 of a 4-rank fake group (``dryrun.trace_lm``
    with a ``RankMesh``) beside JAX's ``parse_collectives`` of the step
    compiled with every layer unrolled (``scan_unroll``; the scan body is
    once in the HLO otherwise).

    The flash-decode combine's all-reduces are equal in bytes: a float32
    max and denominator (B/2, H) and numerator (B/2, H, dh) a layer.  The
    other kinds differ by design: the port gathers each weight's
    ``"data"`` blocks (the FSDP all-gather) and q's heads over
    ``"model"``, and sums row-parallel products and the vocabulary-parallel
    embedding over ``"model"`` (all-reduce, float32); XLA's partitioner
    picks its own layout (it splits D over ``"data"``, all-to-alls q, and
    reduces the norms' sums), so its all-gather, all-to-all and
    collective-permute bytes have no counterpart line by line."""
    cfg = get_reduced("qwen3-4b")
    jcfg = dataclasses.replace(jax_get_reduced("qwen3-4b"), scan_unroll=True)
    mesh = _jmesh((2, 2))
    model = jax_get_model(jcfg)
    pshapes, pspecs = model.abstract_init()
    cshapes, cspecs = model.abstract_cache(4, 64)
    nsh = lambda spec: jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                                    is_leaf=lambda x: isinstance(x, P))
    with compat.set_mesh(mesh):
        fn = lambda p, c, t, pos: model.decode_step(mesh, p, c, t, pos, ("data",))
        compiled = jax.jit(fn, in_shardings=(nsh(pspecs), nsh(cspecs),
                                             NamedSharding(mesh, P(("data",))),
                                             NamedSharding(mesh, P()))).lower(
            pshapes, cshapes, jax.ShapeDtypeStruct((4,), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32)).compile()
    hlo = compiled.as_text()
    jax_coll = jax_dryrun.parse_collectives(hlo)
    Hp, dh = cfg.n_heads_padded, cfg.head_dim
    jax_flash = _jax_flash_bytes(hlo, 2, Hp, dh)
    port = dryrun.trace_meshed(cfg, ("data", "model"), (2, 2),
                                      dict(seq=64, batch=4, kind="decode"))
    shapes = _flash_shapes(2, Hp, dh)
    port_flash = sum(shapes.get(shp, 0) for kind, dtype, shp in port["collective_log"]
                     if kind == "all-reduce" and dtype == "torch.float32")
    assert jax_flash == cfg.n_layers * 4 * 2 * Hp * (2 + dh)
    assert port_flash == jax_flash
    assert set(port["collectives"]) == {"all-reduce", "all-gather", "total"}
    assert jax_coll["all-reduce"] >= jax_flash
    assert port["collectives"]["all-reduce"] > port_flash
