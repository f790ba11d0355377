"""The port's optimizers, LR schedule, synthetic LM batches, training step,
restart-exact loop and LM training CLI, against the JAX package's on the
CPU.

Bounds: the optimizers' parameters and state within rtol 1e-6 of JAX's
(a few float32 ulps: ``pow``, ``sqrt`` and the means may round an ulp
apart) and atol 1e-7 (an ulp of the O(1) operands, for an element where
``b1 m + (1 - b1) g`` cancels: 3.7e-9 seen, XLA fusing what the port
rounds twice) after each of 4 steps on the same gradients, each package
going on from its own state; the schedule within rtol 1e-6; the batches equal
to the bit; the bf16-gradient step's loss within the ``LOSS_ATOL`` and
its gradients within the ``GRAD_REL`` of ``tests/test_torch_lm_train.py``
(readings over six seeds, stated there; this test reads 0.0016 and
0.024 at qwen3-4b, 0.0056 and 0.074 at rwkv6).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_reduced as jax_get_reduced
from repro.models.registry import get_model as jax_get_model
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro.train.schedule import warmup_cosine as jax_warmup_cosine

from repro_torch.configs import get_reduced
from repro_torch.launch import train as train_cli
from repro_torch.models import get_model, params_from_jax
from repro_torch.train import adafactor, adamw, fit, lm_batch_fn, make_train_step
from repro_torch.train.optimizer import tree_map
from repro_torch.train.schedule import warmup_cosine

from test_torch_lm_train import (
    AS_WRITTEN,
    GRAD_REL,
    GRAD_REL_DEFAULT,
    LOSS_ATOL,
    NO_EXCESS,
    batch_np,
    leaves,
    redraw_constants,
    to_jax,
    to_port,
)

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"vec": (7,), "mat": (5, 6), "stack": [(3, 4, 5)]}


def _tree(rng, shapes):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, v) for v in shapes]
    return rng.normal(size=shapes).astype(np.float32)


def _close(got, want, what):
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}{path}")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(name):
    """4 steps on the same gradients: a rank-1, a rank-2 and a rank-3 leaf
    (Adafactor factors the last two), parameters and state after each."""
    rng = np.random.default_rng(0)
    port_opt, jax_o = {"adamw": (adamw(lr=1e-2), jax_opt.adamw(lr=1e-2)),
                       "adafactor": (adafactor(lr=1e-2), jax_opt.adafactor(lr=1e-2))}[name]
    p0 = _tree(rng, SHAPES)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jax_o.init(jp)
    tp = tree_map(torch.from_numpy, p0)
    ts = port_opt.init(tp)
    upd = jax.jit(jax_o.update)
    for step in range(4):
        g = _tree(rng, SHAPES)
        jp, js = upd(jax.tree.map(jnp.asarray, g), js, jp, jnp.asarray(step, jnp.int32))
        out_p, out_s = port_opt.update(tree_map(torch.from_numpy, g), ts, tp,
                                       torch.tensor(step, dtype=torch.int32))
        assert out_p is tp and out_s is ts  # written in place
        _close(tp, jax.tree.map(np.asarray, jp), f"step {step} params")
        _close(ts, jax.tree.map(np.asarray, js), f"step {step} state")
    if name == "adafactor":
        assert set(ts["mat"]) == {"vr", "vc"} and set(ts["vec"]) == {"v"}
        assert tuple(ts["stack"][0]["vr"].shape) == (3, 4)
        assert tuple(ts["stack"][0]["vc"].shape) == (3, 5)


@pytest.mark.parametrize("kw", [{}, {"peak": 1e-3, "warmup": 10, "total": 100, "floor": 0.2}])
def test_warmup_cosine_matches_jax(kw):
    """At 0, the warmup edge and either side of it, mid-cosine, ``total``
    and past it."""
    w, t = kw.get("warmup", 1000), kw.get("total", 100_000)
    steps = np.array([0, 1, w - 1, w, w + 1, (w + t) // 2, t - 1, t, 3 * t], np.int32)
    got = warmup_cosine(torch.from_numpy(steps), **kw)
    want = np.asarray(jax_warmup_cosine(jnp.asarray(steps), **kw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", [0, 7])
def test_lm_batches_equal_jax_to_the_bit(seed):
    cfg = get_reduced("qwen3-4b")
    jb = jax_loop.lm_batch_fn(jax_get_reduced("qwen3-4b"), n_docs=100, seq=16, batch=3,
                              seed=seed)
    tb = lm_batch_fn(cfg, n_docs=100, seq=16, batch=3, seed=seed, device="cpu")
    for step in (0, 1, 5):
        a, b = tb(step), jb(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == torch.int32
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


@pytest.mark.parametrize("name", ["qwen3-4b", "rwkv6-1.6b"])
def test_bf16_gradient_step_matches_jax(mesh11, name):
    """``grad_dtype="bf16"``: the step differentiates a bf16 copy of every
    float32 master (rwkv6's f32 entries too) and hands the optimizer bf16
    gradients, as JAX does; rwkv6 against JAX compiled with excess
    precision off, with the recurrent families' bound."""
    jcfg = dataclasses.replace(jax_get_reduced(name), grad_dtype="bf16")
    cfg = dataclasses.replace(get_reduced(name), grad_dtype="bf16")
    jmodel = jax_get_model(jcfg)
    params = redraw_constants(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
                              np.random.default_rng(0))
    batch = batch_np(cfg, 0)
    compute = jax.tree.map(lambda p: jnp.asarray(p, jnp.bfloat16), params)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jmodel.train_loss(p, b)))
    jb = to_jax(batch)
    with compat.set_mesh(mesh11):
        if cfg.family in AS_WRITTEN:
            fn = fn.lower(compute, jb).compile(compiler_options=NO_EXCESS)
        jloss, jgrads = fn(compute, jb)
    jgrads = dict(leaves(jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads)))

    model = get_model(cfg, device="cpu")
    masters = params_from_jax(cfg, params, device="cpu", masters=True)
    seen = {}

    class Recording:
        @staticmethod
        def update(grads, state, params, step):
            seen["grads"] = grads
            return params, state

    step = torch.zeros((), dtype=torch.int32)
    loss = make_train_step(model, Recording)(masters, None, step, to_port(batch))
    assert int(step) == 1
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    for path, g in leaves(seen["grads"]):
        assert g.dtype == torch.bfloat16, path
        want = jgrads[path]
        rel = np.linalg.norm(g.float().numpy() - want) / np.linalg.norm(want)
        assert rel <= GRAD_REL.get(cfg.family, GRAD_REL_DEFAULT), (path, rel)
    for path, t in leaves(masters):
        assert t.dtype == torch.float32, path


def test_crash_resume_bit_exact(tmp_path):
    """The port's counterpart of ``tests/test_distributed.py::
    test_crash_resume_bit_exact``: 6 steps with a checkpoint every 2, and a
    run that 'crashes' after 4 then resumes from step 4, end on the same
    parameters and the same last two losses, to the bit."""
    cfg = get_reduced("qwen3-4b")
    model = get_model(cfg, device="cpu")
    batch_fn = lm_batch_fn(cfg, n_docs=100, seq=16, batch=2, device="cpu")
    p_full, losses_full = fit(model, batch_fn, steps=6, ckpt_dir=None)
    d = str(tmp_path / "run")
    fit(model, batch_fn, steps=4, ckpt_dir=d, ckpt_every=2)  # "crashes" at 4
    assert sorted(os.listdir(d)) == ["step-2", "step-4"]
    p_resumed, losses_resumed = fit(model, batch_fn, steps=6, ckpt_dir=d, ckpt_every=2)
    assert losses_resumed == losses_full[4:]
    for (path, a), (_, b) in zip(leaves(p_full), leaves(p_resumed)):
        assert a.dtype == torch.float32 and torch.equal(a, b), path


def test_cli_trains_a_reduced_lm_on_the_cpu(capsys):
    out = train_cli.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                          "--steps", "6", "--batch", "2", "--seq", "16"])
    text = capsys.readouterr().out
    assert out["device"] == "cpu" and len(out["losses"]) == 6
    assert out["losses"][-1] < out["losses"][0]
    assert "first loss" in text and "-> last loss" in text and "ms/step" in text


def test_cli_refuses_the_encoder_decoder():
    """JAX's CLI fails with ``KeyError: 'frames'`` here; the port's refuses
    with a message naming the frames it lacks."""
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", "whisper-small", "--reduced", "--device", "cpu"])
    assert e.value.code != 0 and "frames" in str(e.value.code)


def test_cli_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])
