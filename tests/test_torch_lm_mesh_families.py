"""The port's recurrent and encoder-decoder families served on a ``("data",
"model")`` device mesh (rwkv6, the RG-LRU hybrid, whisper) against the
JAX package's on a mesh of the same shape, on the CPU.

One 4-rank gloo world (``run_ranks(..., device="cpu")``), spawned once for
the module, runs every case of the port through ``registry.get_model``
and returns each rank's results; a mesh smaller than the world, (1, 1),
takes the first rank.  JAX runs its counterparts on conftest's 4 host
devices, each jitted with its inputs placed by ``param_specs``,
``abstract_cache``'s specs and the batch's ``P(dp)``.  Weights are JAX's
``init`` with its constant entries (the token-shift mixes, ``w0``, ``u``,
the conv kernel, Λ, the gates, every norm's scale and every bias) redrawn
with numpy, as the one-device tests of the three families redraw them,
and cross to the port through ``params_from_jax(..., mesh=)``; prompts,
frames and the teacher-forced tokens are drawn with numpy.

Bounds: each family's own from its one-device test against JAX
(``tests/test_torch_lm_{rwkv6,rglru,whisper}.py``), which hold at the
mesh unchanged:

* logits within 0.125 (rwkv6), 0.25 (rglru) and 0.0625 (whisper) of JAX's
  at the same mesh, prefill and 3 teacher-forced decode steps (largest
  seen on (2, 2) and (1, 4): 0.061 rwkv6, 0.109 rglru, 0.0127 whisper),
  so equal argmaxes wherever JAX's top two logits are more than twice that
  apart.  JAX's own logits move with the mesh: its (2, 2) and (1, 4)
  logits leave its (1, 1) ones by up to 0.066 (rwkv6), 0.094 (rglru) and
  0.0137 (whisper) on these inputs, and the port's one-device logits leave
  JAX's (1, 1) ones by 0.059, 0.105 and 0.0122.  The port's meshed logits
  equal its one-device ones to the bit for rwkv6 and rglru, and leave them
  by 0.0039 for whisper (float32 partial sums over ``"model"`` rounded once
  to bf16, and the flash-decode combine);
* each rank's cache shard against JAX's shard on the device at its
  coordinates, after prefill and after the last step: rwkv6's ``xt`` and
  ``xc`` within min(2^-3, 2^-4 of the layer's largest magnitude) and its
  WKV state within 2^-5 of the layer's largest magnitude; rglru's
  carries within 2^-4 of the layer's largest magnitude, the bf16 ones
  (conv, ring k/v) also within 2^-2; whisper's k, v, xk and xv within
  2^-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import compat
from repro.configs import get_reduced as jax_get_reduced
from repro.launch import dryrun as jax_dryrun
from repro.models.registry import get_model as jax_get_model

from repro_torch.configs import get_reduced
from repro_torch.gbdt.distributed import run_ranks
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankMesh, shard_shape
from repro_torch.models import get_model, params_from_jax
from repro_torch.models.base import MESH_DP, leaves, map_leaves, param_specs, shard, with_dp
from test_torch_lm_mesh import _Coords, _flash_shapes, _jax_flash_bytes, _jmesh
from test_torch_lm_rglru import _redraw as _redraw_rglru
from test_torch_lm_rwkv6 import _redraw as _redraw_rwkv6
from test_torch_lm_whisper import _redraw as _redraw_whisper

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 host devices (see conftest XLA_FLAGS)"
)

WORLD = 4
MESHES = [(2, 2), (1, 4)]
ARCHS = {"rwkv6-1.6b": 0.125, "recurrentgemma-9b": 0.25, "whisper-small": 0.0625}
B1_ARCHS = ["rwkv6-1.6b", "recurrentgemma-9b"]  # the families that run long_500k
# batch, prompt (the reduced hybrid's 16-slot window, so 3 steps wrap its
# ring), cache slots, decode steps, whisper's encoder frames
B, S, SMAX, STEPS, S_ENC = 4, 16, 24, 3, 8
#: each family's one-device test's redraw of ``init``'s constant entries
REDRAW = {"rwkv6-1.6b": _redraw_rwkv6, "recurrentgemma-9b": _redraw_rglru,
          "whisper-small": _redraw_whisper}


def _inputs(name, batch=B, seed=1):
    """The arch's weights (JAX's ``init``, its constant entries redrawn as
    the family's one-device test redraws them), a prompt (``batch``, S), whisper's frames
    (``batch``, S_ENC, D) and STEPS teacher-forced tokens (``batch``,)."""
    cfg = jax_get_reduced(name)
    params = REDRAW[name](jax.tree.map(np.asarray, jax_get_model(cfg).init(
        jax.random.PRNGKey(0))), np.random.default_rng(0))
    rng = np.random.default_rng(seed)
    inp = {"params": params,
           "tokens": rng.integers(0, cfg.vocab, size=(batch, S)).astype(np.int32),
           "forced": rng.integers(0, cfg.vocab, size=(STEPS, batch)).astype(np.int32)}
    if cfg.family == "encdec":
        frames = rng.normal(size=(batch, S_ENC, cfg.d_model)).astype(np.float32)
        inp["frames"] = np.asarray(jnp.asarray(frames, jnp.bfloat16).astype(jnp.float32))
    return inp


# --------------------------------------------------------------------------
# the port's world: every case on 4 gloo ranks
# --------------------------------------------------------------------------


def _snap(cache):
    """A cache as float32 host arrays (``length`` kept)."""
    return map_leaves(lambda _, t: t.float().numpy().copy() if isinstance(t, torch.Tensor)
                      else t, cache)


def _port_run(name, mesh, inp, dp=MESH_DP):
    """Prefill and the teacher-forced steps through ``get_model`` on ``mesh``
    (None: the one-device path): the rank's logits and caches, one a step."""
    model = get_model(get_reduced(name), "cpu")
    params = params_from_jax(model.cfg, inp["params"], device="cpu", mesh=mesh)
    batch = {"tokens": torch.from_numpy(inp["tokens"]).long()}
    if "frames" in inp:
        batch["frames"] = torch.from_numpy(inp["frames"]).to(torch.bfloat16)
    kw = {} if mesh is None else {"mesh": mesh, "dp": dp}
    logits, cache = model.prefill(params, batch, SMAX, **kw)
    out = {"logits": [logits.numpy()], "caches": [_snap(cache)]}
    for tok in inp["forced"]:
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok).long(), **kw)
        out["logits"].append(logits.numpy())
        out["caches"].append(_snap(cache))
    return out


def _refusals(name, mesh, inp) -> dict:
    """The messages of the calls a mesh refuses (or "no error")."""
    model = get_model(get_reduced(name), "cpu")
    params = params_from_jax(model.cfg, inp["params"], device="cpu", mesh=mesh)
    bad = {"tokens": torch.zeros((3, S), dtype=torch.long)}
    frames = torch.zeros((B, S_ENC, model.cfg.d_model), dtype=torch.bfloat16)
    calls = {"batch": lambda: model.prefill(
        params, {**bad, **({"frames": frames[:3]} if "frames" in inp else {})}, SMAX, mesh=mesh)}
    if "frames" in inp:
        good = {"tokens": torch.zeros((B, S), dtype=torch.long)}
        calls["self"] = lambda: model.alloc_cache(B, SMAX + 1, mesh=mesh, enc_seq=S_ENC)
        calls["cross"] = lambda: model.prefill(params, {**good, "frames": frames[:, :5]},
                                               SMAX, mesh=mesh)
    out = {}
    for what, call in calls.items():
        try:
            call()
            out[what] = "no error"
        except ValueError as e:
            out[what] = str(e)
    return out


def _world(rank, device, inputs):
    out = {}
    meshes = {shape: RankMesh(shape, device_type="cpu") for shape in MESHES + [(1, 1)]}
    with torch.no_grad():
        for name in ARCHS:
            inp = inputs[name]
            for shape, mesh in meshes.items():
                if mesh.member:
                    out["lm", name, shape] = _port_run(name, mesh, inp)
            if name in B1_ARCHS:  # long_500k's form: one row, whole on every rank
                out["b1", name] = _port_run(name, meshes[(2, 2)], inputs["b1", name], dp=None)
            if rank == 0:
                out["unmeshed", name] = _port_run(name, None, inp)
            for shape in MESHES:
                out["refuse", name, shape] = _refusals(name, meshes[shape], inp)
            model = get_model(get_reduced(name), "cpu")
            out["init", name] = map_leaves(lambda _, t: t.float().numpy(),
                                           model.init(0, mesh=meshes[(2, 2)]))
    out["coords"] = {shape: mesh.coords for shape, mesh in meshes.items()}
    return out


@pytest.fixture(scope="module")
def inputs():
    got = {name: _inputs(name) for name in ARCHS}
    got.update({("b1", name): _inputs(name, batch=1, seed=2) for name in B1_ARCHS})
    return got


@pytest.fixture(scope="module")
def world(inputs):
    return run_ranks(_world, WORLD, inputs, device="cpu")


def _ranks(world, key, shape):
    """(coords, value) of every rank that ran ``key`` on ``shape``."""
    return [(r["coords"][shape], r[key]) for r in world if key in r]


# --------------------------------------------------------------------------
# JAX at the same mesh
# --------------------------------------------------------------------------


def _fix_dp(spec, dp):
    return P(*(dp if e == "data" else e for e in spec))


@functools.lru_cache(maxsize=None)
def _jax_run(name, shape, b1=False):
    """JAX's prefill and teacher-forced steps on a ``shape`` mesh: logits
    (global, one a step) and the caches after prefill and after the last
    step, placed by ``abstract_cache``'s specs, with their mesh.  ``b1``: the one-row
    batch, whole on every data rank (``dp=None``)."""
    inp = _inputs(name, batch=1, seed=2) if b1 else _inputs(name)
    dp = None if b1 else ("data",)
    cfg = jax_get_reduced(name)
    model = jax_get_model(cfg)
    mesh = _jmesh(shape)
    batch_n = inp["tokens"].shape[0]
    _, pspecs = model.abstract_init()
    kw = {"enc_seq": S_ENC} if cfg.family == "encdec" else {}
    _, cspecs = model.abstract_cache(batch_n, SMAX, **kw)
    isp = lambda x: isinstance(x, P)  # noqa: E731
    cspecs = jax.tree.map(lambda s: _fix_dp(s, dp), cspecs, is_leaf=isp)
    nsh = lambda spec: jax.tree.map(lambda s: NamedSharding(mesh, s), spec, is_leaf=isp)  # noqa: E731
    with compat.set_mesh(mesh):
        params = jax.device_put(inp["params"], nsh(pspecs))
        batch = {"tokens": jax.device_put(jnp.asarray(inp["tokens"]),
                                          NamedSharding(mesh, P(dp, None)))}
        if "frames" in inp:
            batch["frames"] = jax.device_put(jnp.asarray(inp["frames"], jnp.bfloat16),
                                             NamedSharding(mesh, P(dp, None, None)))
        logits, cache = jax.jit(lambda p, b: model.prefill(p, b, dp))(params, batch)
        if cfg.family == "encdec":  # the self-attention cache grows to SMAX slots
            pad = lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, SMAX - S), (0, 0), (0, 0)])  # noqa: E731
            cache = {**cache, "k": pad(cache["k"]), "v": pad(cache["v"])}
        cache = jax.device_put(cache, nsh(cspecs))
        caches = [cache]
        step = jax.jit(lambda p, c, t, pos: model.decode_step(mesh, p, c, t, pos, dp))
        out = [np.asarray(logits)]
        for i, t in enumerate(inp["forced"]):
            tok = jax.device_put(jnp.asarray(t), NamedSharding(mesh, P(dp)))
            logits, cache = step(params, cache, tok, jnp.asarray(S + i, jnp.int32))
            out.append(np.asarray(logits))
        # a step's output cache is placed as XLA chose: put it back by the specs
        caches.append(jax.device_put(cache, nsh(cspecs)))
    return out, caches, mesh


def _jax_shard(a, mesh, coords) -> np.ndarray:
    """JAX's shard of the placed array ``a`` on the device at ``coords``."""
    dev = mesh.devices[coords["data"], coords["model"]]
    (s,) = [s.data for s in a.addressable_shards if s.device == dev]
    return np.asarray(s, np.float32)


def _logits_agree(got, want, atol):
    """Within ``atol``, so the argmax is equal wherever JAX's top two logits
    are more than twice that apart."""
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * atol
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def _state_agrees(name: str, n: str, want: np.ndarray, got: np.ndarray) -> None:
    """Cache leaf ``n`` of arch ``name`` (layers first) within its family's
    bound (module docstring)."""
    assert got.shape == want.shape, n
    if name == "whisper-small":
        assert np.abs(got - want).max() <= 2.0 ** -4, n
        return
    for a, b in zip(want, got):
        big = np.abs(a).max()
        if n == "s":
            bound = 2.0 ** -5 * big
        elif n in ("xt", "xc"):
            bound = min(2.0 ** -3, 2.0 ** -4 * big)
        elif n == "lru":
            bound = 2.0 ** -4 * big
        else:  # rglru's bf16 carries: conv, ring k/v
            bound = min(2.0 ** -2, 2.0 ** -4 * big)
        assert np.abs(a - b).max() <= bound, n


def _named_leaves(cache) -> list:
    """(name, leaf) of a cache's arrays, ``length`` left out, in JAX's order
    (a dict's keys sorted), so the port's and JAX's trees pair up."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        {k: v for k, v in cache.items() if k != "length"})
    return [(path[-1].key, a) for path, a in flat]


# --------------------------------------------------------------------------
# (i) prefill and decode on the mesh against JAX at the same mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_and_decode_on_the_mesh_match_jax(world, name, shape):
    cfg = get_reduced(name)
    want, _, _ = _jax_run(name, shape)
    ranks = _ranks(world, ("lm", name, shape), shape)
    assert len(ranks) == shape[0] * shape[1]
    b = B // shape[0]
    for coords, got in ranks:
        d = coords["data"]
        for g, w in zip(got["logits"], want):
            assert g.shape == (b, cfg.padded_vocab)
            _logits_agree(g[:, :cfg.vocab], w[d * b:(d + 1) * b, :cfg.vocab], ARCHS[name])


@pytest.mark.parametrize("at", [0, STEPS], ids=["prefill", "decode"])
@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", list(ARCHS))
def test_each_rank_s_cache_shard_matches_jax_s(world, name, shape, at):
    """Each rank's cache shard against JAX's shard on the device at the
    rank's coordinates, after prefill and after the last decode step."""
    _, caches, mesh = _jax_run(name, shape)
    want = _named_leaves(caches[0 if at == 0 else 1])
    for coords, got in _ranks(world, ("lm", name, shape), shape):
        cache = got["caches"][at]
        assert cache["length"] == S + at
        mine = _named_leaves(cache)
        assert [n for n, _ in mine] == [n for n, _ in want]
        for (n, a), (_, g) in zip(want, mine):
            _state_agrees(name, n, _jax_shard(a, mesh, coords), g)


# --------------------------------------------------------------------------
# (ii) one rank on each axis is the one-device path
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ARCHS))
def test_one_rank_on_each_axis_is_the_unmeshed_path_to_the_bit(world, name):
    ((_, meshed),) = _ranks(world, ("lm", name, (1, 1)), (1, 1))
    unmeshed = world[0]["unmeshed", name]
    for a, b in zip(meshed["logits"], unmeshed["logits"]):
        assert np.array_equal(a, b)
    for ca, cb in zip(meshed["caches"], unmeshed["caches"]):
        for (n, a), (_, b) in zip(_named_leaves(ca), _named_leaves(cb)):
            assert np.array_equal(a, b), n


# --------------------------------------------------------------------------
# (iii) long_500k's form: one row, whole on every data rank
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", B1_ARCHS)
def test_one_row_with_no_data_split_gives_every_rank_the_same_logits(world, name):
    """``dp=None`` on (2, 2): every rank computes the row, and all four
    return the same logits, within the family's bound of JAX's with the
    batch replicated; each rank's state holds the whole row."""
    want, caches, mesh = _jax_run(name, (2, 2), b1=True)
    ranks = _ranks(world, ("b1", name), (2, 2))
    assert len(ranks) == WORLD
    first = ranks[0][1]["logits"]
    vocab = get_reduced(name).vocab
    for coords, got in ranks:
        for g, f, w in zip(got["logits"], first, want):
            assert g.shape[0] == 1 and np.array_equal(g, f)
            _logits_agree(g[:, :vocab], w[:, :vocab], ARCHS[name])
        for (n, a), (_, g) in zip(_named_leaves(caches[1]), _named_leaves(got["caches"][-1])):
            assert g.shape[1] == 1, n
            _state_agrees(name, n, _jax_shard(a, mesh, coords), g)


# --------------------------------------------------------------------------
# (iv) the hybrid's ring wraps on the mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_the_ring_wraps_on_the_mesh(world, shape):
    """The reduced hybrid's 16-token prompt fills its 16-slot ring, so each
    decode step overwrites the oldest slot, ``pos % W``: on every rank
    that slot alone changes, and every ``"model"`` rank of a data shard
    holds the same ring, bit for bit (K/V whole on every rank)."""
    W = get_reduced("recurrentgemma-9b").local_window
    assert S == W
    ranks = _ranks(world, ("lm", "recurrentgemma-9b", shape), shape)
    by_shard = {}
    for coords, got in ranks:
        rings = [c["segments"][0][2] for c in got["caches"]]
        for i in range(STEPS):
            for n in ("k", "v"):
                changed = np.any(rings[i + 1][n] != rings[i][n], axis=(0, 1, 3, 4))
                assert np.flatnonzero(changed).tolist() == [(S + i) % W], (n, i)
        by_shard.setdefault(coords["data"], []).append(rings[-1])
    for rings in by_shard.values():
        for r in rings[1:]:
            assert all(np.array_equal(r[n], rings[0][n]) for n in ("k", "v"))


# --------------------------------------------------------------------------
# (vi) refusals; init's shards
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", list(ARCHS))
def test_a_batch_the_data_axis_does_not_divide_is_refused(world, name, shape):
    for _, msg in _ranks(world, ("refuse", name, shape), shape):
        if shape[0] == 1:  # one data shard divides every batch
            assert msg["batch"] == "no error"
        else:
            assert "3 rows" in msg["batch"] and f"{shape[0]} shards" in msg["batch"]


@pytest.mark.parametrize("what", ["self", "cross"])
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_a_whisper_length_the_model_axis_does_not_divide_is_refused(world, shape, what):
    """A self-attention cache of SMAX + 1 slots, an encoder of 5 frames:
    ``ValueError`` naming the length and the model axis's size."""
    n = SMAX + 1 if what == "self" else 5
    ranks = _ranks(world, ("refuse", "whisper-small", shape), shape)
    assert len(ranks) == WORLD
    for _, msg in ranks:
        assert f"{what}-attention" in msg[what] and f"{n} slots" in msg[what]
        assert f"{shape[1]} ranks" in msg[what]


@pytest.mark.parametrize("name", list(ARCHS))
def test_init_on_the_mesh_is_the_shard_of_the_unmeshed_init(world, name):
    """``init(mesh=)`` draws every entry whole, in the same order, and keeps
    the rank's block: ``base.shard`` of the one-device ``init``'s entry."""
    cfg = get_reduced(name)
    whole = get_model(cfg, "cpu").init(0)
    specs = param_specs(cfg)
    for coords, got in _ranks(world, ("init", name), (2, 2)):
        mesh = _Coords((2, 2), (coords["data"], coords["model"]))
        for (n, w), (_, sp), (_, g) in zip(leaves(whole), leaves(specs), leaves(got)):
            assert np.array_equal(shard(w, sp, mesh).float().numpy(), g), (n, coords)


# --------------------------------------------------------------------------
# the dry run: every family's decode cells trace the meshed step
# --------------------------------------------------------------------------

CELLS = [("rwkv6-1.6b", "decode_32k"), ("rwkv6-1.6b", "long_500k"),
         ("recurrentgemma-9b", "decode_32k"), ("recurrentgemma-9b", "long_500k"),
         ("whisper-small", "decode_32k")]
TINY = {"decode_32k": dict(seq=64, batch=4, kind="decode"),
        "long_500k": dict(seq=64, batch=1, kind="decode")}


@pytest.fixture
def tiny_cells(monkeypatch):
    """``lower_cell`` on the reduced configs, the 2x2 production mesh and
    the tiny shapes of :data:`TINY`."""
    from repro_torch import configs
    from repro_torch.launch import input_specs
    from repro_torch.launch.mesh import make_test_mesh

    monkeypatch.setattr(configs, "get_config", get_reduced)
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda multi_pod: make_test_mesh(2, 2))
    for shape, info in TINY.items():
        monkeypatch.setitem(input_specs.SHAPES, shape, info)


@pytest.mark.parametrize("arch,shape", CELLS, ids=lambda c: c)
def test_dry_run_record_of_a_new_meshed_decode_cell(tiny_cells, arch, shape):
    """Per-device collectives by kind and peak from the meshed trace; the
    argument bytes are the shards of the cell's own batch split (``_dp``:
    none for long_500k's one row)."""
    from repro_torch.launch.input_specs import _dp, decode_specs
    from repro_torch.launch.mesh import make_test_mesh

    rec = dryrun.lower_cell(arch, shape, False)
    assert rec["status"] == "OK" and rec["n_chips"] == 4 and rec["kind"] == "decode"
    assert "peak_live_bytes_global" not in rec
    assert rec["collectives_note"].startswith("the meshed decode step")
    assert rec["peak_live_bytes_per_device"] > rec["memory"]["argument_size_in_bytes"]
    coll = rec["collectives_per_device"]
    assert coll["total"] == coll["all-reduce"] + coll["all-gather"] > 0
    cfg, mesh = get_reduced(arch), make_test_mesh(2, 2)
    dp = _dp(mesh, TINY[shape]["batch"])
    assert dp == (None if shape == "long_500k" else ("data",))
    _, cspecs, *_ = decode_specs(cfg, mesh, TINY[shape])
    assert cspecs == with_dp(get_model(cfg, "cpu").module.cache_specs(
        cfg, TINY[shape]["batch"], 64, **({"enc_seq": 32} if arch == "whisper-small" else {})),
        dp)


@pytest.mark.parametrize("shape", list(TINY))
@pytest.mark.parametrize("arch", B1_ARCHS)
def test_the_traced_rank_holds_the_cache_shard_input_specs_gives(arch, shape):
    """The meshed trace's cache is this rank's shard of ``decode_specs``'s
    cache: long_500k's one row whole, the heads or d_rnn split over
    ``"model"``."""
    from repro_torch.launch.input_specs import decode_specs
    from repro_torch.launch.mesh import Mesh

    cfg, info = get_reduced(arch), TINY[shape]
    mesh = Mesh(("data", "model"), (2, 2))
    with dryrun.fake_world(4):
        step = dryrun.lm_step(cfg, mesh, info, rank_mesh=RankMesh((2, 2), device_type="cpu"))
    _, cspecs, *_ = decode_specs(cfg, mesh, info)
    cache = {k: v for k, v in step["args"][1].items() if k != "length"}
    for (n, (shp, dtype, spec)), (_, t) in zip(leaves(cspecs), leaves(cache)):
        assert tuple(t.shape) == shard_shape(shp, spec, mesh) and t.dtype == dtype, n
        assert t.shape[1] == (1 if shape == "long_500k" else 2), n


@pytest.mark.parametrize("shape", list(TINY))
@pytest.mark.parametrize("arch", B1_ARCHS)
def test_dry_run_all_reduce_bytes_are_the_code_s_count(arch, shape):
    """rwkv6's and rglru's all-reduce bytes on 2x2, reckoned from the code:
    the vocabulary-parallel embedding sums one bf16 row a token (b, D) over
    ``"model"``, and every layer sums two row-parallel products in float32
    (b, D): rwkv6's time-mix ``w_o`` and channel-mix ``wc_v``; the hybrid's
    block output (``w_out`` or the attention's ``wo``) and its MLP's
    ``wod``.  b is the rank's rows: 2 of decode_32k's 4, long_500k's 1."""
    cfg, info = get_reduced(arch), TINY[shape]
    b = info["batch"] // 2 if shape == "decode_32k" else 1
    D = cfg.d_model
    want = b * D * 2 + cfg.n_layers * 2 * b * D * 4
    assert want == {("rwkv6-1.6b", "decode_32k"): 2304, ("rwkv6-1.6b", "long_500k"): 1152,
                    ("recurrentgemma-9b", "decode_32k"): 5376,
                    ("recurrentgemma-9b", "long_500k"): 2688}[arch, shape]
    got = dryrun.trace_meshed(cfg, ("data", "model"), (2, 2), info)
    assert got["collectives"]["all-reduce"] == want
    assert set(got["collectives"]) == {"all-reduce", "all-gather", "total"}


def test_whisper_dry_run_flash_combine_bytes_equal_jax_parse_collectives():
    """Reduced whisper-small, one decode step, B 4, a 64-slot self-attention
    cache and JAX's 32 encoder slots, on 2x2: the port traced on rank 0 of
    a 4-rank fake group beside JAX's ``parse_collectives`` of the step
    compiled.  The flash-decode combine runs twice a layer (self- and
    cross-attention), each a float32 max and denominator (B/2, H) and
    numerator (B/2, H, dh).  JAX's whisper ``decode_step`` scans its layers
    with no ``unroll`` (``scan_unroll`` does not reach it), so its HLO holds
    the layer body once and ``parse_collectives`` counts one layer's: the
    port's count is the layers' times that."""
    cfg = get_reduced("whisper-small")
    jcfg = dataclasses.replace(jax_get_reduced("whisper-small"), scan_unroll=True)
    mesh = _jmesh((2, 2))
    model = jax_get_model(jcfg)
    pshapes, pspecs = model.abstract_init()
    enc = 64 // cfg.frontend_len_div
    cshapes, cspecs = model.abstract_cache(4, 64, enc_seq=enc)
    nsh = lambda spec: jax.tree.map(lambda s: NamedSharding(mesh, s), spec,  # noqa: E731
                                    is_leaf=lambda x: isinstance(x, P))
    with compat.set_mesh(mesh):
        fn = lambda p, c, t, pos: model.decode_step(mesh, p, c, t, pos, ("data",))  # noqa: E731
        compiled = jax.jit(fn, in_shardings=(nsh(pspecs), nsh(cspecs),
                                             NamedSharding(mesh, P(("data",))),
                                             NamedSharding(mesh, P()))).lower(
            pshapes, cshapes, jax.ShapeDtypeStruct((4,), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32)).compile()
    hlo = compiled.as_text()
    Hp, dh = cfg.n_heads_padded, cfg.head_dim
    jax_flash = _jax_flash_bytes(hlo, 2, Hp, dh)
    port = dryrun.trace_meshed(cfg, ("data", "model"), (2, 2),
                                      dict(seq=64, batch=4, kind="decode"))
    shapes = _flash_shapes(2, Hp, dh)
    port_flash = sum(shapes.get(shp, 0) for kind, dtype, shp in port["collective_log"]
                     if kind == "all-reduce" and dtype == "torch.float32")
    assert jax_flash == 2 * 4 * 2 * Hp * (2 + dh)
    assert port_flash == cfg.n_layers * jax_flash
    assert jax_dryrun.parse_collectives(hlo)["all-reduce"] >= jax_flash
