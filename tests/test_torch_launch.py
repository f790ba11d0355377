"""The port's launch tooling (``repro_torch.launch.{mesh, input_specs,
dryrun, sweep}``, ``param_specs``, ``cache_specs``, the optimizers'
``state_specs``) against the JAX package's, in one process.

Exact throughout: parameter counts, sharding trees, optimizer state
shardings, input and cache shapes and shardings, per-device argument bytes
of a training step against JAX's compiled ``memory_analysis()`` on a 2×2
mesh (one reduced config of each family module), a dense forward's FLOPs
against the closed form, the rwkv probe against a whole trace, and the
``toad_gbdt`` cell's all-reduce bytes against ``parse_collectives`` of
JAX's compiled ``shard_map`` on 4 host devices, each byte that differs
named.  Stated factors where the port differs by design: serving weights
bf16 (JAX's abstract parameters float32) and serving tokens int64.
"""

import dataclasses
import json
import math
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import repro.launch.input_specs as jax_specs
from repro import compat
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs import list_archs
from repro.launch import dryrun as jax_dryrun
from repro.launch import sweep as jax_sweep
from repro.models.registry import get_model as jax_get_model
from repro.train.loop import make_train_step as jax_train_step
from repro.train.optimizer import get_optimizer as jax_get_optimizer

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.launch import dryrun, input_specs, sweep
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh, shard_shape
from repro_torch.models import count_params, param_shapes, param_specs
from repro_torch.models.registry import _tensors
from repro_torch.train.optimizer import get_optimizer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import dryrun_place  # noqa: E402

# stand-ins for JAX's production meshes: its input specs read only these
JAX_MESHES = {
    "single": SimpleNamespace(axis_names=("data", "model"), shape={"data": 16, "model": 16}),
    "multi": SimpleNamespace(axis_names=("pod", "data", "model"),
                             shape={"pod": 2, "data": 16, "model": 16}),
}
# one reduced config of each family module, cut to one layer (recurrentgemma
# to one (rglru, rglru, attn) pattern) so each JAX compile stays short
FAMILY_CUTS = {"qwen3-4b": dict(n_layers=1), "rwkv6-1.6b": dict(n_layers=1),
               "recurrentgemma-9b": dict(n_layers=3),
               "whisper-small": dict(n_layers=1, n_enc_layers=1)}
TINY = {"train": dict(seq=32, batch=4, kind="train"),
        "prefill": dict(seq=32, batch=4, kind="prefill")}


def jax_leaves(tree):
    """JAX's (path, leaf) pairs, a ``PartitionSpec`` a leaf."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jax.tree_util.keystr(p), x) for p, x in flat]


def port_leaves(tree, path=""):
    """The port's (path, leaf) pairs in JAX's ``keystr`` form, a tuple a leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += port_leaves(tree[k], f"{path}['{k}']")
        return out
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in port_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def padded(spec, rank):
    """A sharding with one entry a dimension (the port's form), an entry of
    one axis name written as the name: JAX's ``PartitionSpec`` writes
    ``("data",)`` as ``"data"``, the same sharding."""
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
    return spec + (None,) * (rank - len(spec))


def jax_shard_bytes(shape, dtype, spec, mesh):
    """Per-device bytes of one JAX leaf, from its own ``PartitionSpec``."""
    n = 1
    for size, e in zip(shape, padded(spec, len(shape))):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        n *= -(-size // math.prod(mesh.shape[a] for a in names))
    return n * np.dtype(dtype).itemsize


# --------------------------------------------------------------------------
# cells, skips, meshes
# --------------------------------------------------------------------------


def test_shapes_skips_and_the_82_cells_match_jax():
    assert input_specs.SHAPES == jax_specs.SHAPES
    assert input_specs.SUBQUADRATIC == jax_specs.SUBQUADRATIC
    assert list(ARCHS) == list(list_archs())
    cells = [(a, s) for a in ARCHS for s in input_specs.SHAPES]
    reasons = {(a, s): input_specs.skip_reason(get_config(a), s) for a, s in cells}
    assert len(cells) == 40
    assert sum(r is not None for r in reasons.values()) == 8
    for (a, s), r in reasons.items():
        assert r == jax_specs.skip_reason(jax_get_config(a), s)
    assert list(sweep.cells()) == list(jax_sweep.cells())
    assert len(list(sweep.cells())) == 82


def test_production_mesh_and_dp_axes():
    for name, multi in (("single", False), ("multi", True)):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.axis_names == JAX_MESHES[name].axis_names
        assert mesh.shape == JAX_MESHES[name].shape
        for b in (1, 2, 4, 16, 32, 128, 256, 512):
            assert input_specs._dp(mesh, b) == jax_specs._dp(JAX_MESHES[name], b)
    assert make_test_mesh(1, 1).size == 1
    # XLA pads an uneven split: every device holds the ceiling
    assert shard_shape((10, 7), (("data", "model"), None), make_test_mesh(2, 2)) == (3, 7)


# --------------------------------------------------------------------------
# parameters: counts and shardings, all 10 archs at full width
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_counts_and_specs_match_jax_at_full_width(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jshapes, jspecs = jax_get_model(jcfg).abstract_init()
    shapes = param_shapes(cfg)
    assert count_params(shapes) == jax_dryrun.count_params(jshapes)
    assert dryrun.count_active_params(cfg, shapes) == \
        jax_dryrun.count_active_params(jcfg, jshapes)
    mine = port_leaves(param_specs(cfg))
    theirs = jax_leaves(jspecs)
    shape_of = {p: x.shape for p, x in jax_leaves(jshapes)}
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, spec), (_, jspec) in zip(mine, theirs):
        assert spec == padded(jspec, len(shape_of[path])), path


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "llama4-maverick-400b-a17b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "whisper-small"])
def test_optimizer_state_specs_match_jax(arch, name):
    cfg = get_config(arch)
    jshapes, jspecs = jax_get_model(jax_get_config(arch)).abstract_init()
    mine = get_optimizer(name).state_specs(param_specs(cfg), param_shapes(cfg))
    theirs = jax_get_optimizer(name).state_specs(jspecs, jshapes)
    jstate = jax.eval_shape(jax_get_optimizer(name).init, jshapes)
    ranks = {p: len(x.shape) for p, x in jax_leaves(jstate)}
    got, want = port_leaves(mine), jax_leaves(theirs)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, spec), (_, jspec) in zip(got, want):
        assert spec == padded(jspec, ranks[path]), path


def test_adafactor_factors_by_rank_and_needs_shapes():
    opt = get_optimizer("adafactor")
    with pytest.raises(ValueError, match="needs param shapes"):
        opt.state_specs({"w": ("data", "model")})
    # a spec that leaves trailing dimensions out is padded before factoring
    specs = {"w": ("model",), "b": (), "e": (None, "data")}
    shapes = {"w": (8, 4, 2), "b": (5,), "e": (3, 6)}
    assert opt.state_specs(specs, shapes) == {
        "w": {"vr": ("model", None), "vc": ("model", None)},
        "b": {"v": (None,)},
        "e": {"vr": (None,), "vc": ("data",)},
    }
    jopt = jax_get_optimizer("adafactor").state_specs(
        {k: P(*v) for k, v in specs.items()}, {k: jnp.zeros(s) for k, s in shapes.items()})
    assert {k: {n: tuple(p) for n, p in v.items()} for k, v in jopt.items()} == \
        opt.state_specs(specs, shapes)
    assert get_optimizer("adamw").state_specs(specs) == {"m": specs, "v": specs}


# --------------------------------------------------------------------------
# inputs and caches: every family at every shape, both meshes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_and_cache_specs_match_jax(arch, mesh_name):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mesh, jmesh = make_production_mesh(multi_pod=mesh_name == "multi"), JAX_MESHES[mesh_name]
    jmodel = jax_get_model(jcfg)
    for shape, info in input_specs.SHAPES.items():
        if input_specs.skip_reason(cfg, shape):
            continue
        batch, bspec, dp = input_specs.batch_specs(cfg, mesh, shape)
        jbatch, jbspec, jdp = jax_specs.batch_specs(jcfg, jmesh, shape)
        assert dp == jdp and sorted(batch) == sorted(jbatch)
        for k, t in batch.items():
            assert t.device.type == "meta" and tuple(t.shape) == jbatch[k].shape, (shape, k)
            assert padded(bspec[k], t.dim()) == padded(jbspec[k], t.dim()), (shape, k)
            # tokens: int32 for training (JAX's dtype); the serve path's int64
            want = str(jbatch[k].dtype)
            if info["kind"] != "train" and want == "int32":
                want = "int64"
            assert dtype_name(t.dtype) == want, (shape, k)
        if info["kind"] != "decode":
            continue
        cache, cspecs, token, tspec, pos, cdp = input_specs.decode_specs(cfg, mesh, shape)
        jc, jcs, jtok, jtspec, _, jcdp = jax_specs.decode_specs(jmodel, jmesh, shape)
        assert cdp == jcdp and padded(tspec, 1) == padded(jtspec, 1)
        assert tuple(token.shape) == jtok.shape
        assert token.dtype == torch.int64 and pos == info["seq"] - 1
        jl = dict(jax_leaves(jcs))
        jshape = {p: (x.shape, x.dtype) for p, x in jax_leaves(jc)}
        mine = port_leaves(cspecs)
        # the port's ``length`` is a host int; JAX's an int32 scalar (4 B)
        assert sorted(p for p, _ in mine) == sorted(p for p in jl if p != "['length']")
        port_bytes = jax_bytes = 0
        for path, (shp, dtype, spec) in mine:
            assert shp == jshape[path][0], (shape, path)
            assert dtype_name(dtype) == str(jshape[path][1]), (shape, path)
            assert padded(spec, len(shp)) == padded(jl[path], len(shp)), (shape, path)
            port_bytes += dryrun.shard_bytes(shp, dtype, spec, mesh)
            jax_bytes += jax_shard_bytes(shp, jshape[path][1], jl[path], jmesh)
        assert port_bytes == jax_bytes > 0
        assert dryrun.spec_bytes(cspecs, mesh) == port_bytes
        assert {p: (tuple(t.shape), t.dtype) for p, t in port_leaves(
            {k: v for k, v in cache.items() if k != "length"})} == \
            {p: (shp, dtype) for p, (shp, dtype, _) in mine}


# --------------------------------------------------------------------------
# argument bytes against JAX's compiled memory_analysis (2x2 mesh)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh():
    return compat.make_mesh((2, 2), ("data", "model"))


def _nsh(mesh, spec):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                        is_leaf=lambda x: isinstance(x, P))


def _jax_train_args(arch, mesh):
    cfg = dataclasses.replace(jax_get_reduced(arch), **FAMILY_CUTS[arch])
    model = jax_get_model(cfg)
    pshapes, pspecs = model.abstract_init()
    B, S = TINY["train"]["batch"], TINY["train"]["seq"]
    bshapes, bspecs, dp = {}, {}, ("data",)
    if cfg.family == "encdec":
        bshapes["frames"] = jax.ShapeDtypeStruct((B, S // cfg.frontend_len_div, cfg.d_model),
                                                 jnp.bfloat16)
        bspecs["frames"] = P(dp, None, None)
    bshapes.update(tokens=jax.ShapeDtypeStruct((B, S), jnp.int32),
                   labels=jax.ShapeDtypeStruct((B, S), jnp.int32))
    bspecs.update(tokens=P(dp, None), labels=P(dp, None))
    opt = jax_get_optimizer(cfg.optimizer, cfg.learning_rate)
    oshapes = jax.eval_shape(opt.init, pshapes)
    ospecs = opt.state_specs(pspecs, pshapes)
    with compat.set_mesh(mesh):
        compiled = jax.jit(
            jax_train_step(model, opt, dp),
            in_shardings=(_nsh(mesh, pspecs), _nsh(mesh, ospecs), NamedSharding(mesh, P()),
                          _nsh(mesh, bspecs)),
            donate_argnums=(0, 1),
        ).lower(pshapes, oshapes, jax.ShapeDtypeStruct((), jnp.int32), bshapes).compile()
    return compiled.memory_analysis().argument_size_in_bytes


@pytest.mark.parametrize("arch", list(FAMILY_CUTS))
def test_train_argument_bytes_equal_jax_memory_analysis(arch, jax_mesh):
    cfg = dataclasses.replace(get_reduced(arch), **FAMILY_CUTS[arch])
    step = dryrun.lm_step(cfg, make_test_mesh(2, 2), TINY["train"])
    assert step["arg_bytes"] == _jax_train_args(arch, jax_mesh)


def test_serving_argument_bytes_differ_from_jax_by_the_stated_factor(jax_mesh):
    """Prefill: the port's weights are bf16 but ``F32_ENTRIES`` (JAX's
    abstract parameters float32, so a bf16 leaf's shard is half), and its
    tokens int64 (JAX's int32, so twice)."""
    arch = "rwkv6-1.6b"  # bf16 leaves and float32 ones (F32_ENTRIES)
    cfg = dataclasses.replace(get_reduced(arch), **FAMILY_CUTS[arch])
    jcfg = dataclasses.replace(jax_get_reduced(arch), **FAMILY_CUTS[arch])
    model = jax_get_model(jcfg)
    pshapes, pspecs = model.abstract_init()
    jax_specs.SHAPES["_tiny_prefill"] = TINY["prefill"]
    try:
        bshapes, bspecs, dp = jax_specs.batch_specs(jcfg, jax_mesh, "_tiny_prefill")
    finally:
        del jax_specs.SHAPES["_tiny_prefill"]
    with compat.set_mesh(jax_mesh):
        compiled = jax.jit(lambda p, b: model.prefill(p, b, dp),
                           in_shardings=(_nsh(jax_mesh, pspecs), _nsh(jax_mesh, bspecs))
                           ).lower(pshapes, bshapes).compile()
    jax_args = compiled.memory_analysis().argument_size_in_bytes
    mesh = make_test_mesh(2, 2)
    step = dryrun.lm_step(cfg, mesh, TINY["prefill"])
    params, batch = step["args"]
    f32_bytes = sum(dryrun.shard_bytes(t.shape, torch.float32, s, mesh) for (_, t), (_, s)
                    in zip(port_leaves(params), port_leaves(param_specs(cfg))))
    port_params = dryrun.tree_bytes(params, param_specs(cfg), mesh)
    tokens = dryrun.shard_bytes(batch["tokens"].shape, torch.int32, (("data",), None), mesh)
    assert f32_bytes // 2 < port_params < f32_bytes  # bf16 leaves, and float32 ones
    assert step["arg_bytes"] == jax_args - (f32_bytes - port_params) + tokens


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-1.6b", "recurrentgemma-9b"])
def test_cli_placed_arguments_are_the_dry_runs(arch, kind):
    """The arguments that the training and serving CLIs' own paths place
    (``chip_smoke.dryrun_place``: ``init``, ``opt.init``, ``lm_batch_fn``;
    ``prefill``'s cache and ``argmax``'s token) are the dry run's, tensor
    for tensor by shape and dtype, and their bytes its argument bytes on
    one device: what ``chip_smoke``'s [dryrun] (b) holds against
    ``memory_allocated`` on the card."""
    cfg = dataclasses.replace(get_reduced(arch), **FAMILY_CUTS[arch])
    info = dict(seq=40, batch=2, kind=kind)
    _, args = dryrun_place(torch.device("cpu"), cfg, info)
    step = dryrun.lm_step(cfg, make_test_mesh(1, 1), info)
    key = lambda t: (tuple(t.shape), str(t.dtype))  # noqa: E731
    assert sorted(map(key, _tensors(args))) == sorted(map(key, _tensors(step["args"])))
    assert sum(t.nbytes for t in _tensors(args)) == step["arg_bytes"]


# --------------------------------------------------------------------------
# the trace: FLOPs, the probe
# --------------------------------------------------------------------------


def test_dense_forward_flops_equal_the_closed_form():
    cfg = get_reduced("qwen3-4b")
    B, S = 2, 40  # S not a multiple of q_chunk: the padded tail is computed too
    got = dryrun.trace_lm(cfg, make_test_mesh(1, 1), dict(seq=S, batch=B, kind="prefill"))
    D, dh, F, Vp = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.padded_vocab
    KVp, Gp = cfg.padded_heads
    H = KVp * Gp
    c = min(cfg.q_chunk, S)
    Sp = -(-S // c) * c
    per_layer = (2 * B * S * D * (H + 2 * KVp) * dh    # q, k, v
                 + 2 * 2 * B * H * Sp * S * dh          # scores and p·v, every chunk
                 + 2 * B * S * H * dh * D               # o
                 + 3 * 2 * B * S * D * F)               # swiglu
    assert got["flops"] == cfg.n_layers * per_layer + 2 * B * D * Vp  # last-token logits


def test_rwkv_probe_equals_a_whole_trace():
    """The depth probe at 2, 3 and 4 layers, solved for 5, equals a whole
    5-layer trace to the integer: FLOPs, bytes moved and the peak.  At one
    layer the peak falls in another part of the step, so a probe from one
    layer is refused."""
    cfg = dataclasses.replace(get_reduced("rwkv6-1.6b"), n_layers=5)
    mesh = make_test_mesh(2, 2)
    for shape in (dict(seq=16, batch=2, kind="train"), dict(seq=64, batch=4, kind="prefill")):
        probe = dryrun.probe_lm(cfg, mesh, shape)
        whole = dryrun.trace_lm(cfg, mesh, shape)
        for m in ("flops", "bytes_moved", "peak_live_bytes", "arg_bytes", "out_bytes"):
            assert probe[m] == whole[m], (shape["kind"], m)
    with pytest.raises(ValueError, match="peak_live_bytes is not affine"):
        dryrun.probe_lm(cfg, mesh, shape, layers=(1, 2, 3))


def test_cli_skip_record_has_jax_reason(capsys):
    res = dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k", "--mesh", "single"])
    assert res["status"] == "SKIP"
    assert res["reason"] == jax_specs.skip_reason(jax_get_config("qwen3-4b"), "long_500k")
    assert json.loads(capsys.readouterr().out)["status"] == "SKIP"


# --------------------------------------------------------------------------
# toad_gbdt: collectives on a fake group against JAX's compiled shard_map
# --------------------------------------------------------------------------


def test_fake_process_group_is_where_the_dry_run_takes_it():
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: F401

    with dryrun.fake_world(256) as group:
        x = torch.empty((3, 5), device="meta")
        torch.distributed.all_reduce(x, group=group)
        assert group.size() == 256 and group.rank() == 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("bits", [0, 16])
def test_gbdt_allreduce_bytes_match_jax_shard_map(bits):
    """Port = JAX + 8 B (the global row count, int64, CEGB's denominator;
    JAX divides by the shard's rows).  Quantized: less JAX's 4 B psum of
    ones (the group's size: the port reads ``get_world_size``), and at 16
    bits the payload twice JAX's (carried as int32: gloo and NCCL have no
    int16 sum)."""
    from repro.configs.toad_gbdt import reduced as jax_reduced
    from repro.gbdt.distributed import _out_specs
    from repro.gbdt.trainer import train as jax_train
    from repro_torch.configs.toad_gbdt import reduced

    wl, jwl = reduced(), jax_reduced()
    jcfg = dataclasses.replace(jwl.gbdt, n_rounds=1, hist_quant_bits=bits)
    mesh = compat.make_mesh((4,), ("data",))
    fn = compat.shard_map(lambda b, y, e: jax_train(jcfg, b, y, e, axis_name="data"),
                          mesh=mesh, in_specs=(P("data"), P("data"), P()),
                          out_specs=_out_specs(jcfg, "data"), check_vma=False)
    args = (jax.ShapeDtypeStruct((jwl.rows, jwl.n_features), jnp.int8),
            jax.ShapeDtypeStruct((jwl.rows,), jnp.float32),
            jax.ShapeDtypeStruct((jwl.n_features, jwl.n_bins - 1), jnp.float32))
    with compat.set_mesh(mesh):
        compiled = jax.jit(fn).lower(*args).compile()
    jax_coll = jax_dryrun.parse_collectives(compiled.as_text())
    got = dryrun.trace_gbdt(wl, dataclasses.replace(wl.gbdt, n_rounds=1, hist_quant_bits=bits),
                            4)
    assert set(got["collectives"]) == {"allreduce_"}
    assert got["arg_bytes"] == compiled.memory_analysis().argument_size_in_bytes
    D, d, B = wl.gbdt.max_depth, wl.n_features, wl.n_bins
    if bits == 0:
        assert got["collectives"]["allreduce_"] == jax_coll["all-reduce"] + 8
        return
    payload = sum(2 ** lvl * d * B * 3 for lvl in range(D)) + 2 ** D * 3  # no subtraction
    assert got["collectives"]["allreduce_"] == jax_coll["all-reduce"] + 8 - 4 + 2 * payload


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------


def test_sweep_skips_an_ok_record_and_writes_fail(tmp_path, monkeypatch, capsys):
    ok = sweep.out_path(str(tmp_path), "qwen3-4b", "train_4k", "single")
    with open(ok, "w") as f:
        json.dump({"status": "OK"}, f)
    monkeypatch.setattr(sweep, "cells", lambda: iter([
        ("qwen3-4b", "train_4k", "single"), ("no-such-arch", "train_4k", "single"),
        ("qwen3-4b", "train_4k", "multi")]))
    sweep.main(["--results", str(tmp_path), "--only-mesh", "single", "--timeout", "120"])
    out = capsys.readouterr().out
    assert "[skip-existing]" in out and "no-such-arch train_4k single: FAIL" in out
    with open(ok) as f:
        assert json.load(f) == {"status": "OK"}
    with open(sweep.out_path(str(tmp_path), "no-such-arch", "train_4k", "single")) as f:
        assert json.load(f)["status"] == "FAIL"
    assert not os.path.exists(sweep.out_path(str(tmp_path), "qwen3-4b", "train_4k", "multi"))
