"""The dry run's meshed prefill and training cells (``launch/dryrun.py``):
the step traced on rank 0 of a fake process group, its collectives by kind
held to a count worked out from the code (``tools/dryrun_table.py``'s
``reckon``, from the parameter tables: every family's prefill and
training step, on (2, 2) and two pods) and, where the kind and the layout
are the same, to JAX's ``parse_collectives`` of the same step
compiled on a 2x2 mesh of conftest's 4 host devices, as the JAX dry run
compiles it (``src/repro/launch/dryrun.py``), with ``scan_unroll`` so that
every layer is in the HLO (a scan body is there once).

Where both packages do the same thing, the bytes are equal:

* the FSDP gathers of a prefill's weights but the embedding: JAX's
  partitioner gathers each weight's ``"data"`` blocks at its use, as
  ``base.wcast`` does, once a layer; JAX's abstract weights are float32
  and a served port's bf16, so this compares elements (JAX looks the
  embedding up in place and all-reduces the rows, where the port gathers
  the table's ``"data"`` blocks);
* the row-parallel sums: a float32 all-reduce of the (B/data, S, D)
  partial products, two a layer (``wo``, and ``wod`` or the MoE's
  combine) in a prefill.

In a training step JAX gathers some weights once more in its backward,
for their transposed products (``wo``, the head, the experts), where the
port's autograd keeps the weight its recompute gathered: there the port's
weight gathers are held below JAX's.

The rest differ by design and are held to the code's count: the port
sums the vocabulary-parallel embedding in bf16, gathers a prefill's
logits over ``"model"`` (a training step's cross entropy is
vocabulary-parallel: three float32 sums a row), reduce-scatters an FSDP
gather's gradient (JAX's CPU partitioner all-reduces it), sums in the
backward the gradient of a tensor whole on every ``"model"`` rank where
it feeds the rank's heads, d_ff columns, experts or vocabulary, and sums
the gradients of the leaves not split over ``"data"``; XLA picks its own
layouts for the activations (its all-to-alls and collective-permutes).
"""

import dataclasses
import math
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import compat
from repro.configs import get_reduced as jax_get_reduced
from repro.models.registry import get_model as jax_get_model
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import get_optimizer as jax_get_optimizer

from repro_torch.configs import ARCHS, get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 host devices (see conftest XLA_FLAGS)"
)

MESH = (2, 2)
NAMES = sorted(ARCHS)
B, S = 4, 16
PREFILL = dict(seq=S, batch=B, kind="prefill")
TRAIN = dict(seq=S, batch=B, kind="train")


def _jax_hlo(name, kind) -> str:
    cfg = dataclasses.replace(jax_get_reduced(name), scan_unroll=True)
    mesh = compat.make_mesh(MESH, ("data", "model"))
    model = jax_get_model(cfg)
    pshapes, pspecs = model.abstract_init()
    nsh = lambda spec: jax.tree.map(lambda s: NamedSharding(mesh, s), spec,  # noqa: E731
                                    is_leaf=lambda x: isinstance(x, P))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    dp = ("data",)
    with compat.set_mesh(mesh):
        if kind == "prefill":
            fn = lambda p, b: model.prefill(p, b, dp)  # noqa: E731
            lowered = jax.jit(fn, in_shardings=(nsh(pspecs), nsh({"tokens": P(dp, None)}))) \
                .lower(pshapes, {"tokens": tok})
        else:
            opt = jax_get_optimizer(cfg.optimizer, cfg.learning_rate)
            bspecs = {"tokens": P(dp, None), "labels": P(dp, None)}
            fn = jax_make_train_step(model, opt, dp)
            lowered = jax.jit(fn, in_shardings=(
                nsh(pspecs), nsh(opt.state_specs(pspecs, pshapes)), NamedSharding(mesh, P()),
                nsh(bspecs))).lower(pshapes, jax.eval_shape(opt.init, pshapes),
                                    jax.ShapeDtypeStruct((), jnp.int32),
                                    {"tokens": tok, "labels": tok})
    return lowered.compile().as_text()


def _jax_results(hlo: str, kind: str) -> list:
    """(dtype, shape) of each result of JAX's collectives of ``kind``,
    tuple members too."""
    out = []
    for line in hlo.splitlines():
        m = re.match(rf"\s*%\S+ = (.*?) {kind}(-start)?\(", line)
        if m:
            out += [(t, tuple(int(n) for n in dims.split(",") if n))
                    for t, dims in re.findall(r"(\w+)\[([\d,]*)\]", m.group(1))]
    return out


def _activation(shape) -> bool:
    """A result shaped like activations: it leads with the batch or a data
    shard of it (the reduced weights lead with 64, 32 or the 1 of a
    stacked layer)."""
    return bool(shape) and shape[0] in (B, B // MESH[0])


def _port(name, info) -> list:
    cfg = get_reduced(name)
    return cfg, dryrun.trace_meshed(cfg, ("data", "model"), MESH, info)


def _numel(log, want) -> int:
    return sum(math.prod(shape) for kind, dtype, shape in log if want(kind, dtype, shape))


def _bytes(log, want) -> int:
    size = {"torch.float32": 4, "torch.bfloat16": 2, "torch.int64": 8, "torch.int32": 4}
    return sum(math.prod(shape) * size[dtype] for kind, dtype, shape in log
               if want(kind, dtype, shape))


# --------------------------------------------------------------------------
# the count from the code: tools/dryrun_table.py's reckoning
# --------------------------------------------------------------------------

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from dryrun_table import reckon  # noqa: E402  (the count PERF.md's predictions come from)

RECKONED = [(name, kind, sizes) for name in NAMES for kind in ("prefill", "train")
            for sizes in (MESH, (2, 2, 2))]


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,kind,sizes", RECKONED, ids=str)
def test_meshed_collectives_are_the_code_count(name, kind, sizes):
    """Rank 0's collective bytes by kind in every family's meshed prefill
    and training step, on (2, 2) and a two-pod (2, 2, 2), equal
    ``tools/dryrun_table.py``'s reckoning from the parameter tables (its
    docstring lists the terms)."""
    cfg = get_reduced(name)
    axes = ("pod", "data", "model")[-len(sizes):]
    info = dict(seq=S, batch=2 * B, kind=kind)
    got = dryrun.trace_meshed(cfg, axes, sizes, info)["collectives"]
    want = {k: v for k, v in reckon(cfg, info, Mesh(axes, sizes)).items()}
    assert {k: v for k, v in got.items() if k != "total"} == want


@pytest.mark.parametrize("name", ["qwen3-4b", "olmoe-1b-7b"])
def test_meshed_prefill_collectives_beside_jax(name):
    cfg, got = _port(name, PREFILL)
    log = got["collective_log"]
    hlo = _jax_hlo(name, "prefill")
    jax_weights = sum(math.prod(s) for t, s in _jax_results(hlo, "all-gather")
                      if not _activation(s))
    embed = (cfg.padded_vocab // MESH[1], cfg.d_model // MESH[0])  # a block of the table
    assert _numel(log, lambda k, d, s: k == "all-gather" and d == "torch.bfloat16"
                  and s != embed) == jax_weights
    b = B // MESH[0]
    jax_rows = sum(4 * math.prod(s) for t, s in _jax_results(hlo, "all-reduce")
                   if t == "f32" and s == (b, S, cfg.d_model))
    port_rows = _bytes(log, lambda k, d, s: k == "all-reduce" and d == "torch.float32"
                       and math.prod(s) == b * S * cfg.d_model)
    assert port_rows == jax_rows == 2 * cfg.n_layers * 4 * b * S * cfg.d_model


@pytest.mark.parametrize("name", ["qwen3-4b", "olmoe-1b-7b"])
def test_meshed_train_collectives_beside_jax(name):
    cfg, got = _port(name, TRAIN)
    log = got["collective_log"]
    hlo = _jax_hlo(name, "train")
    jax_weights = sum(4 * math.prod(s) for t, s in _jax_results(hlo, "all-gather")
                      if t == "f32" and not _activation(s))
    embed = (cfg.padded_vocab // MESH[1], cfg.d_model // MESH[0])
    port_weights = _bytes(log, lambda k, d, s: k == "all-gather" and not _activation(s)
                          and s != embed)
    assert 0 < port_weights <= jax_weights
    assert _jax_results(hlo, "reduce-scatter") == []  # JAX all-reduces its gradients here


def test_rwkv6_meshed_prefill_probe_is_the_whole_trace():
    """rwkv6's prefill cells are solved from traces at 2, 3 and 4 layers:
    meshed, the line also holds the collective calls and bytes of each
    kind, and solved for 5 layers it is the 5-layer trace to the integer."""
    cfg = dataclasses.replace(get_reduced("rwkv6-1.6b"), n_layers=5)
    mesh = Mesh(("data", "model"), MESH)
    tracer = lambda c, m, sh: dryrun.trace_meshed(c, m.axis_names, m.sizes, sh)  # noqa: E731
    solved = dryrun.probe_lm(cfg, mesh, PREFILL, tracer=tracer)
    whole = tracer(cfg, mesh, PREFILL)
    for m in ("flops", "bytes_moved", "peak_live_bytes", "collective_calls"):
        assert solved[m] == whole[m], m
    assert solved["collectives"] == whole["collectives"]
    assert whole["collectives"]["all-reduce"] > 0 and whole["collectives"]["all-gather"] > 0


def test_meshed_prefill_and_train_records(monkeypatch):
    """``lower_cell`` (reduced configs, a 2x2 production mesh): every
    prefill and training cell carries rank 0's collectives and peak;
    rwkv6's training cell is the meshed step solved from its depth probe,
    and nothing of the one-device training record is left."""
    from repro_torch import configs
    from repro_torch.launch import input_specs
    from repro_torch.launch.mesh import make_test_mesh

    monkeypatch.setattr(configs, "get_config", get_reduced)
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda multi_pod: make_test_mesh(*MESH))
    monkeypatch.setitem(input_specs.SHAPES, "prefill_32k", PREFILL)
    monkeypatch.setitem(input_specs.SHAPES, "train_4k", TRAIN)
    for arch, shape in (("qwen3-4b", "prefill_32k"), ("llava-next-34b", "train_4k"),
                        ("whisper-small", "prefill_32k"),
                        ("recurrentgemma-9b", "prefill_32k")):
        rec = dryrun.lower_cell(arch, shape, False)
        coll = rec["collectives_per_device"]
        assert coll["total"] == sum(v for k, v in coll.items() if k != "total") > 0, arch
        assert rec["peak_live_bytes_per_device"] > 0 and "peak_live_bytes_global" not in rec
        assert ("reduce-scatter" in coll) == (shape == "train_4k"), arch
    rec = dryrun.lower_cell("rwkv6-1.6b", "train_4k", False)
    coll = rec["collectives_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total") > 0
    assert coll["reduce-scatter"] > 0 and rec["peak_live_bytes_per_device"] > 0
    assert rec["collectives_note"] == "the meshed train step, rank 0 of a fake group"
    assert rec["probe"]["solved_for"] == get_reduced("rwkv6-1.6b").n_layers
    assert "peak_live_bytes_global" not in rec
    assert not hasattr(dryrun, "NO_COLLECTIVES") and not hasattr(dryrun, "MESHED_TRAINING")
    assert torch.distributed.is_initialized() is False


def test_a_rank_mesh_takes_the_card_unless_told_the_cpu(monkeypatch):
    """``RankMesh(shape)`` follows the port's device rule: without a card
    it raises the port's "no card" error (before it looks for a process
    group) rather than building a CPU mesh; the dry run's fake world and
    the CPU tests pass ``device_type="cpu"``."""
    from repro_torch.launch.mesh import RankMesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RankMesh((1, 1))
    with pytest.raises(ValueError, match="initialised world"):
        RankMesh((1, 1), device_type="cpu")  # the CPU asked for: no world here
