"""The vocabulary-parallel cross entropy of the port's meshed training
(``transformer._ce_loss`` on a rank's vocabulary block of the logits), the
training cells' collectives without the logits' gather, and a reduced
rwkv6's meshed checkpoint restored onto another mesh, on the CPU.

One 4-rank gloo world (``run_ranks(..., device="cpu")``), spawned once
for the module:

* the loss and its gradient on a (B, S, Vp) float32 logits tensor drawn
  with numpy, the vocab mask added, with ``-1`` labels and labels on the
  edges of the ``"model"`` blocks (a block's first and last id), each rank
  holding its data shard's rows of its vocabulary block: against the
  unmeshed ``_ce_loss`` of the whole logits (what every rank computed from
  the gathered logits before), the loss within float32 rounding
  (``LOSS_RTOL``) and each rank's block of the gradient within
  ``GRAD_ATOL`` of the whole gradient's block;
* rwkv6 (reduced) fitted 2 AdamW steps on (2, 2) with a checkpoint at
  step 2, restored onto (1, 4): every rank's shards of the masters and of
  the optimizer's state are the saved leaves' blocks to the bit.

On rank 0 of a fake process group (``launch.dryrun.trace_meshed``, the
meta device): no family's meshed training step gathers logits over
``"model"`` (a prefill still gathers its last token's), and the loss's
three float32 sums a row are there.  Where the kind is the same as JAX's,
the three newly meshed families' weight gathers are held beside JAX's
``parse_collectives`` of the same 2x2 step, as
``tests/test_torch_lm_mesh_dryrun.py`` holds the transformer family's.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import compat
from repro.configs import get_reduced as jax_get_reduced
from repro.models.registry import get_model as jax_get_model
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import get_optimizer as jax_get_optimizer

from repro_torch.configs import ARCHS, get_reduced
from repro_torch.gbdt.distributed import run_ranks
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import get_model
from repro_torch.models.base import shard
from repro_torch.models.transformer import _ce_loss

from test_torch_lm_mesh_dryrun import _activation, _jax_results
from test_torch_lm_mesh_train import _Coords, _spec_leaves

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 host devices (see conftest XLA_FLAGS)"
)

WORLD = 4
MESHES = [(2, 2), (1, 4)]
B, S, VOCAB, VP = 4, 8, 500, 512  # VP: the vocabulary padded to 256s, 4 blocks of 128
LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-7
CKPT = ("rwkv6-1.6b", 2)  # (arch, steps: the checkpoint at the last)


def _ce_inputs():
    """Logits (B, S, VP) float32 (the padded ids' -1e9 added) and labels
    (B, S): -1 at a few positions, every block's first and last id, the
    rest drawn with numpy."""
    rng = np.random.default_rng(11)
    logits = (3.0 * rng.normal(size=(B, S, VP))).astype(np.float32)
    logits[..., VOCAB:] += np.float32(-1e9)
    labels = rng.integers(0, VOCAB, size=(B, S)).astype(np.int64)
    edges = [0, 127, 128, 255, 256, 383, 384, VOCAB - 1]  # the blocks of 2 and of 4
    labels[1, :len(edges)] = edges
    labels[2, len(edges) // 2:] = list(reversed(edges))[:S - len(edges) // 2]
    labels[0, :2] = labels[3, -1] = -1
    return logits, labels


def _ce_rank(mesh, logits, labels) -> dict:
    """This rank's loss and its block of the gradient."""
    rows = B // mesh.axis_size("data")
    n = VP // mesh.axis_size("model")
    r0, c0 = mesh.axis_index("data") * rows, mesh.axis_index("model") * n
    block = torch.from_numpy(logits[r0:r0 + rows, :, c0:c0 + n].copy()).requires_grad_(True)
    loss = _ce_loss(block, torch.from_numpy(labels[r0:r0 + rows]), mesh)
    (grad,) = torch.autograd.grad(loss, [block])
    return {"loss": float(loss), "grad": grad.numpy(), "rows": (r0, rows), "cols": (c0, n)}


def _ckpt_rank(mesh22, mesh14, tmp: str) -> dict:
    """:data:`CKPT` on (2, 2) with a checkpoint at its last step, restored
    onto (1, 4): this rank's saved and restored shards (host float32)."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.train.loop import fit, lm_batch_fn, state_layout
    from repro_torch.train.optimizer import get_optimizer, tree_map

    name, steps = CKPT
    cfg = get_reduced(name)
    model = get_model(cfg, device="cpu")
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    specs, _ = state_layout(cfg, opt)
    host = lambda tree: tree_map(lambda t: t.numpy().copy(), tree)  # noqa: E731
    params, _ = fit(model, lm_batch_fn(cfg, 100, 16, 4, device="cpu"), steps=steps,
                    ckpt_dir=tmp, ckpt_every=steps, mesh=mesh22)
    template = {"params": params, "opt": opt.init(params)}
    saved = host(ckpt.restore(tmp, steps, template, "cpu", mesh=mesh22, specs=specs))
    onto = host(ckpt.restore(tmp, steps, template, "cpu", mesh=mesh14, specs=specs))
    return {"params": host(params), "saved": saved, "onto": onto}


def _world(rank, device, tmp):
    meshes = {shape: RankMesh(shape, device_type="cpu") for shape in MESHES}
    logits, labels = _ce_inputs()
    out = {"coords": {shape: m.coords for shape, m in meshes.items()}}
    for shape, mesh in meshes.items():
        out["ce", shape] = _ce_rank(mesh, logits, labels)
    out["ckpt"] = _ckpt_rank(meshes[(2, 2)], meshes[(1, 4)], tmp)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_ranks(_world, WORLD, str(tmp_path_factory.mktemp("vocab_ce")), device="cpu")


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_vocab_parallel_loss_is_the_gathered_loss(world, shape):
    """Every rank's loss is the whole batch's, and its gradient the whole
    gradient's block at its rows and vocabulary columns, within float32
    rounding, with -1 labels and labels on every block's edges."""
    logits, labels = _ce_inputs()
    whole = torch.from_numpy(logits).requires_grad_(True)
    loss = _ce_loss(whole, torch.from_numpy(labels))
    (grad,) = torch.autograd.grad(loss, [whole])
    grad = grad.numpy()
    for r in world:
        got = r["ce", shape]
        assert got["loss"] == pytest.approx(float(loss.detach()), rel=LOSS_RTOL)
        (r0, rows), (c0, n) = got["rows"], got["cols"]
        np.testing.assert_allclose(got["grad"], grad[r0:r0 + rows, :, c0:c0 + n], rtol=0,
                                   atol=GRAD_ATOL)
        assert np.all(got["grad"][..., max(VOCAB - c0, 0):] == 0)  # the padding's: none


def test_one_model_rank_takes_the_unmeshed_loss_to_the_bit():
    """With one ``"model"`` rank the block is the whole vocabulary and
    ``_ce_loss`` computes what it computes without a mesh, to the bit
    (``logsumexp`` and a gather: no collective)."""

    class One:
        axis_names, shape = ("data", "model"), {"data": 1, "model": 1}

        def axis_size(self, a):
            return 1

    logits, labels = _ce_inputs()
    t = torch.from_numpy(logits)
    assert torch.equal(_ce_loss(t, torch.from_numpy(labels), One()),
                       _ce_loss(t, torch.from_numpy(labels)))


# --------------------------------------------------------------------------
# the meshed training steps' collectives (meta traces)
# --------------------------------------------------------------------------

TRAIN = dict(seq=24, batch=4, kind="train")  # (rows, S) = (2, 24): no leaf's shape


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_no_training_step_gathers_the_logits(name):
    """Rank 0 of a (2, 2) fake group: the meshed training step gathers no
    (rows, S, Vp / model) block of logits over ``"model"``, and it sums
    the cross entropy's three float32 (rows, S) pieces (the row maximum,
    the sum of exponentials, the label's logit); the same config's
    prefill still gathers its last token's (so the check sees such a
    gather: the log holds a gather's pieces, one a rank)."""
    cfg = get_reduced(name)
    b, S_, n = TRAIN["batch"] // 2, TRAIN["seq"], cfg.padded_vocab // 2
    got = dryrun.trace_meshed(cfg, ("data", "model"), (2, 2), TRAIN)
    log = got["collective_log"]
    assert [s for k, d, s in log if k == "all-gather" and s[-1] == n and len(s) == 3] == []
    assert sum(k == "all-reduce" and d == "torch.float32" and s == (b, S_)
               for k, d, s in log) == 3
    pre = dryrun.trace_meshed(cfg, ("data", "model"), (2, 2), {**TRAIN, "kind": "prefill"})
    assert [s for k, d, s in pre["collective_log"] if k == "all-gather"
            and s[-1] == n and len(s) == 3] == [(b, 1, n)] * 2


NEW = ["rwkv6-1.6b", "recurrentgemma-9b", "whisper-small"]


def _jax_train_hlo(name) -> str:
    """JAX's 2x2 training step of the reduced ``name`` compiled as its dry
    run compiles it, every layer unrolled (``scan_unroll``): the HLO."""
    cfg = dataclasses.replace(jax_get_reduced(name), scan_unroll=True)
    mesh = compat.make_mesh((2, 2), ("data", "model"))
    model = jax_get_model(cfg)
    pshapes, pspecs = model.abstract_init()
    nsh = lambda spec: jax.tree.map(lambda s: NamedSharding(mesh, s), spec,  # noqa: E731
                                    is_leaf=lambda x: isinstance(x, P))
    dp, B_, S_ = ("data",), TRAIN["batch"], TRAIN["seq"]
    tok = jax.ShapeDtypeStruct((B_, S_), jnp.int32)
    batch, bspecs = {"tokens": tok, "labels": tok}, {"tokens": P(dp, None), "labels": P(dp, None)}
    if cfg.family == "encdec":
        batch["frames"] = jax.ShapeDtypeStruct((B_, S_ // cfg.frontend_len_div, cfg.d_model),
                                               jnp.bfloat16)
        bspecs["frames"] = P(dp, None, None)
    opt = jax_get_optimizer(cfg.optimizer, cfg.learning_rate)
    with compat.set_mesh(mesh):
        fn = jax_make_train_step(model, opt, dp)
        lowered = jax.jit(fn, in_shardings=(
            nsh(pspecs), nsh(opt.state_specs(pspecs, pshapes)), NamedSharding(mesh, P()),
            nsh(bspecs))).lower(pshapes, jax.eval_shape(opt.init, pshapes),
                                jax.ShapeDtypeStruct((), jnp.int32), batch)
    return lowered.compile().as_text()


@pytest.mark.parametrize("name", NEW)
def test_meshed_train_weight_gathers_beside_jax(name):
    """The newly meshed families' FSDP gathers of their float32 masters
    but the embedding (the port gathers its ``"data"`` blocks where JAX
    looks the rows up in place, or, tied, gathers it for the logits): the
    port gathers weights of the sizes JAX's partitioner gathers and no
    others (how often is the reckoning's: twice a layer, the forward and
    the recompute; XLA's count moves with the shapes, as it weighs
    gathering a weight against moving activations); JAX all-reduces its
    gradients where the port reduce-scatters them."""
    cfg = get_reduced(name)
    log = dryrun.trace_meshed(cfg, ("data", "model"), (2, 2), TRAIN)["collective_log"]
    hlo = _jax_train_hlo(name)
    D, n = cfg.d_model, cfg.padded_vocab // 2
    jax_sizes = {math.prod(s) for t, s in _jax_results(hlo, "all-gather")
                 if t == "f32" and not _activation(s)}
    if name == "whisper-small":  # tied: JAX gathers the embedding for the logits
        jax_sizes.remove(n * D)
    pieces = [math.prod(s) for k, d, s in log if k == "all-gather" and d == "torch.float32"
              and not _activation(s) and s != (n, D // 2)]
    assert pieces and {2 * p for p in pieces} == jax_sizes  # a gather's 2 pieces
    assert _jax_results(hlo, "reduce-scatter") == []


# --------------------------------------------------------------------------
# a meshed checkpoint restored onto another mesh
# --------------------------------------------------------------------------


def _assemble(blocks, spec, shape):
    """The whole leaf of ``shape`` from every rank's block ([(coords,
    block)]), sharded as ``spec`` on (2, 2), the padding dropped."""
    out = np.zeros(shape, dtype=blocks[0][1].dtype)
    for coords, blk in blocks:
        idx = []
        for n, c, e in zip(shape, blk.shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
            lo = min((0 if e is None else coords[e]) * c, n)
            idx.append(slice(lo, min(lo + c, n)))
        out[tuple(idx)] = blk[tuple(slice(0, s.stop - s.start) for s in idx)]
    return out


def test_a_meshed_rwkv6_checkpoint_restores_onto_another_mesh_to_the_bit(world):
    """The masters and AdamW state fitted on (2, 2) and saved at the last
    step: restored on (2, 2) they are the fit's own shards, and restored
    onto (1, 4) every rank holds the saved leaves' (1, 4) blocks, to the
    bit."""
    from repro_torch.train.loop import state_layout
    from repro_torch.train.optimizer import get_optimizer

    from test_torch_lm_train import leaves

    cfg = get_reduced(CKPT[0])
    specs, shapes = state_layout(cfg, get_optimizer(cfg.optimizer, cfg.learning_rate))
    spec_of, shape_of = dict(_spec_leaves(specs)), dict(_spec_leaves(shapes))
    for r in world:
        for (path, a), (_, b) in zip(leaves(r["ckpt"]["params"]),
                                     leaves(r["ckpt"]["saved"]["params"])):
            assert np.array_equal(a, b), path
    for path, spec in spec_of.items():
        blocks = [(r["coords"][(2, 2)], dict(leaves(r["ckpt"]["saved"]))[path]) for r in world]
        whole = _assemble(blocks, spec, shape_of[path])
        for r in world:
            mesh = _Coords((1, 4), r["coords"][(1, 4)])
            want = shard(torch.from_numpy(whole), spec, mesh).numpy()
            assert np.array_equal(dict(leaves(r["ckpt"]["onto"]))[path], want), path
