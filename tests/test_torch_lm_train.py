"""The port's ``train_loss`` and its gradients against the JAX package's
``jax.value_and_grad(train_loss)``, on the CPU, at the 10 reduced
configurations, on float32 masters.

JAX runs jitted on the (1, 1) mesh, as ``tests/test_archs.py`` runs its
train step, one compile an architecture for the module; rwkv6 and rglru
are compiled with ``xla_allow_excess_precision`` off (JAX's bf16 casts as
written: its default compile differs from that one by 0.055-0.070 in the
logits, ROADMAP §C), the others with XLA's default.  Weights are JAX's
``init`` with every constant entry (norms, biases, token-shift mixes, the
decay, the bonus, the conv kernel, Λ, the gates) redrawn as c + 0.25 N(0,
1), so that no gradient is trivially zero, carried to the port with
``params_from_jax(..., masters=True)``.  The batch has
``tests/test_archs.py::_batch``'s keys and shapes (B=2, S=32; whisper's
8 frames, the VLM's 8 patch embeddings whose positions carry label -1),
its tokens, labels, frames and embeddings drawn with numpy.

Routing is discontinuous: an MoE router's logits are bf16, so ties and
one-ulp gaps between experts are common, and a bf16 ulp of difference in
a token's input flips its expert (llama4-maverick, top-1 of 8: one token
in 64 at seeds 0 and 5, moving the loss by 0.013 and 0.025).  So for the
two MoE configurations JAX's routes are recorded (``jax.debug.callback``
on its ``_moe_local``) and the port is run on them (``chip_smoke.
moe_routes``: its ``moe_route`` given JAX's experts, every other quantity
its own); its own routes are held to agree with JAX's on at least
``ROUTE_AGREE`` of the slots.

Bounds, from the readings over seeds 0-5 of this harness (the largest
reading in brackets), with about 1.5x margin:

- the loss within ``LOSS_ATOL`` = 0.01 (0.0064, rwkv6);
- each gradient leaf within ``GRAD_REL`` of JAX's in relative L2 (the
  norm of the difference over the norm of JAX's): 0.08 for the
  transformer family and whisper (0.055, stablelm-12b), 0.16 for rwkv6
  and rglru (0.112, rwkv6's ``wc_v``).  The recurrent families' bound is
  JAX's own spread: its two compiles (XLA's default and excess precision
  off) differ from each other by up to 0.097 on the same leaves (rwkv6,
  seed 4), where the port reads 0.112 against the second;
- each leaf's gradient nonzero wherever JAX's exceeds ``NONZERO_FLOOR`` =
  2^-6 of that leaf's largest magnitude, and below that wherever JAX's is
  exactly zero (elementwise the packages differ by bf16 ulps of the
  summands: JAX sums the embedding's rows in bf16, the port in float32,
  so where repeated tokens cancel one reads 3e-3 of the largest and the
  other 0); the padded heads' and vocabulary rows' gradients are exactly
  zero (a test of their own);
- llama4-maverick's router (top-1: the renormalised weight p / p is 1, so
  its true gradient is 0 and both packages return rounding noise) is held
  absolutely: every element below 1e-6 of the largest gradient in the tree.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro import compat
from repro.configs import get_reduced as jax_get_reduced
from repro.models.registry import get_model as jax_get_model

from repro_torch.configs import ARCHS, get_reduced
from repro_torch.models import get_model, params_from_jax
from repro_torch.models.registry import get_module
from repro_torch.train.optimizer import tree_map

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import moe_routes  # noqa: E402  (the card's phase forces routes alike)

B, S = 2, 32
NAMES = sorted(ARCHS)
NO_EXCESS = {"xla_allow_excess_precision": False}
AS_WRITTEN = ("rwkv", "hybrid")  # compiled with excess precision off
LOSS_ATOL = 0.01
GRAD_REL = {"rwkv": 0.16, "hybrid": 0.16}
GRAD_REL_DEFAULT = 0.08
NONZERO_FLOOR = 2.0 ** -6
NOISE = 1e-6
ROUTE_AGREE = 0.9


def leaves(tree, path=""):
    """(path, leaf) over a nest of dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def redraw_constants(tree, rng):
    """Every entry whose elements are all equal (init's ones and zeros)
    redrawn as c + 0.25 N(0, 1), in place; host arrays."""
    if isinstance(tree, dict):
        return {k: redraw_constants(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [redraw_constants(v, rng) for v in tree]
    a = np.asarray(tree, np.float32)
    if a.size and a.min() == a.max():
        return (a + 0.25 * rng.normal(size=a.shape)).astype(np.float32)
    return a


def batch_np(cfg, seed):
    """``test_archs.py::_batch``'s keys and shapes, drawn from ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    batch, n_text = {}, S
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(B, S // cfg.frontend_len_div, cfg.d_model))
    elif cfg.family == "vlm":
        pe = S // cfg.frontend_len_div
        batch["embeds"] = rng.normal(size=(B, pe, cfg.d_model))
        n_text = S - pe
    batch["tokens"] = rng.integers(0, cfg.vocab, size=(B, n_text)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    if cfg.family == "vlm":
        labels[:, :pe] = -1
    batch["labels"] = labels
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else jnp.int32)
            for k, v in batch.items()}


def to_port(batch, device="cpu"):
    return {k: (torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32
                else torch.from_numpy(v)).to(device) for k, v in batch.items()}


def jax_case(name, seed, mesh):
    """JAX's loss, gradients (host float32, by path), weights (host) and
    batch, and for an MoE config the experts ``_moe_local`` chose, a list
    of (N, k) arrays in layer order."""
    cfg = jax_get_reduced(name)
    model = jax_get_model(cfg)
    params = redraw_constants(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed))),
                              np.random.default_rng(seed))
    batch = batch_np(cfg, seed)
    routes = []
    real = jax_layers._moe_local

    def recording(x, w_router, *args, top_k, **kw):
        logits = jnp.einsum("nd,de->ne", x.reshape(-1, x.shape[-1]),
                            w_router.astype(x.dtype)).astype(jnp.float32)
        _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
        jax.debug.callback(lambda e: routes.append(np.asarray(e)), top_e)
        return real(x, w_router, *args, top_k=top_k, **kw)

    fn = jax.jit(jax.value_and_grad(lambda p, b: model.train_loss(p, b)))
    jp = jax.tree.map(jnp.asarray, params)
    jb = to_jax(batch)
    jax_layers._moe_local = recording
    try:
        with compat.set_mesh(mesh):
            if cfg.family in AS_WRITTEN:
                fn = fn.lower(jp, jb).compile(compiler_options=NO_EXCESS)
            loss, grads = fn(jp, jb)
            loss = float(loss)
    finally:
        jax_layers._moe_local = real
    n_moe = sum(np.asarray(t).shape[0] for p, t in leaves(params) if p.endswith(".router"))
    grads = {p: np.asarray(g, np.float32) for p, g in leaves(jax.tree.map(np.asarray, grads))}
    return {"cfg": cfg, "loss": loss, "grads": grads, "params": params, "batch": batch,
            "routes": routes[:n_moe]}


def port_case(case, routes=None, **replace):
    """The port's loss and gradients (host float32, by path) on ``case``'s
    weights and batch; ``routes`` forces the MoE layers' experts."""
    cfg = dataclasses.replace(get_reduced(case["cfg"].name), **replace)
    model = get_model(cfg, device="cpu")
    params = params_from_jax(cfg, case["params"], device="cpu", masters=True)
    flat = list(leaves(params))
    for _, t in flat:
        t.requires_grad_(True)
    with moe_routes(list(routes or [])):
        loss = model.train_loss(params, to_port(case["batch"]))
        grads = torch.autograd.grad(loss, [t for _, t in flat])
    return {"loss": loss, "params": params,
            "grads": {p: g for (p, _), g in zip(flat, grads)}}


def port_routes(case):
    """The experts the port's own ``moe_route`` picks, in layer order."""
    cfg = get_reduced(case["cfg"].name)
    params = params_from_jax(cfg, case["params"], device="cpu", masters=True)
    with torch.no_grad(), moe_routes([]) as got:
        get_model(cfg, device="cpu").train_loss(params, to_port(case["batch"]))
    return got


def compare(case, got):
    """The readings: |Δloss|, the worst leaf's relative L2 and the counts of
    elements that break the nonzero and zero patterns."""
    cfg = case["cfg"]
    worst, bad_nonzero, bad_zero = 0.0, 0, 0
    top = max(np.abs(g).max() for g in case["grads"].values())
    for path, want in case["grads"].items():
        g = got["grads"][path]
        assert g.dtype == torch.float32 and tuple(g.shape) == want.shape, path
        g = g.numpy()
        if cfg.top_k == 1 and path.endswith(".router"):
            assert np.abs(want).max() <= NOISE * top and np.abs(g).max() <= NOISE * top, path
            continue
        rel = np.linalg.norm(g - want) / np.linalg.norm(want)
        worst = max(worst, rel)
        floor = NONZERO_FLOOR * np.abs(want).max()
        bad_nonzero += int(np.sum((np.abs(want) > floor) & (g == 0)))
        bad_zero += int(np.sum((want == 0) & (np.abs(g) > floor)))
    return {"loss": abs(float(got["loss"]) - case["loss"]), "rel": worst,
            "bad_nonzero": bad_nonzero, "bad_zero": bad_zero}


@pytest.fixture(scope="module")
def cases(mesh11):
    """JAX's case an architecture, compiled once for the module."""
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = jax_case(name, 0, mesh11)
        return memo[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_train_loss_and_gradients_match_jax(cases, name):
    case = cases(name)
    moe = case["cfg"].family == "moe"
    got = port_case(case, routes=case["routes"] if moe else None)
    r = compare(case, got)
    assert r["loss"] <= LOSS_ATOL, r
    assert r["rel"] <= GRAD_REL.get(case["cfg"].family, GRAD_REL_DEFAULT), r
    assert r["bad_nonzero"] == 0 and r["bad_zero"] == 0, r


@pytest.mark.parametrize("name", [n for n in NAMES if get_reduced(n).family == "moe"])
def test_moe_routes_agree_with_jax(cases, name):
    """The port's own routes against the ones JAX took, slot by slot."""
    case = cases(name)
    mine = port_routes(case)
    assert len(mine) == len(case["routes"]) > 0
    agree = np.mean([np.mean(a.reshape(-1) == b.reshape(-1))
                     for a, b in zip(mine, case["routes"])])
    assert agree >= ROUTE_AGREE, agree


@pytest.mark.parametrize("name", ["llama3.2-3b", "llava-next-34b", "whisper-small"])
def test_padded_heads_and_vocabulary_get_no_gradient(name):
    """With the vocabulary cut to 500 (padded to 512), the padded rows of
    the embedding and columns of the head, and the padded q heads' columns
    of ``wq`` (``head_mask``), receive exactly zero."""
    cfg = dataclasses.replace(get_reduced(name), vocab=500)
    assert cfg.padded_vocab == 512
    model = get_model(cfg, device="cpu")
    params = model.init(0, masters=True)
    flat = [(p, t.requires_grad_(True)) for p, t in leaves(params)]
    loss = model.train_loss(params, to_port(batch_np(cfg, 0)))
    got = dict(zip([p for p, _ in flat], torch.autograd.grad(loss, [t for _, t in flat])))
    assert bool((got[".top.embed"][cfg.vocab:] == 0).all())
    assert bool(got[".top.embed"][: cfg.vocab].abs().sum() > 0)
    if ".top.head" in got:
        assert bool((got[".top.head"][:, cfg.vocab:] == 0).all())
    mask = cfg.head_mask().reshape(-1) == 0
    for path in (p for p in got if p.endswith(".wq")):
        cols = got[path].reshape(*got[path].shape[:-1], mask.numel(), cfg.head_dim)
        assert bool((cols[..., mask, :] == 0).all()), path
        assert bool(cols[..., ~mask, :].abs().sum() > 0), path


def test_masters_and_their_gradients_are_float32():
    """Every master (the ``F32_ENTRIES`` among them) is float32 from
    ``init(masters=True)`` and from ``params_from_jax(masters=True)``, and
    receives a float32 gradient; serving's bf16 weights are unchanged."""
    for name in ("rwkv6-1.6b", "recurrentgemma-9b"):
        cfg = get_reduced(name)
        model = get_model(cfg, device="cpu")
        f32 = get_module(cfg).F32_ENTRIES
        assert f32
        masters = model.init(0, masters=True)
        for path, t in leaves(masters):
            assert t.dtype == torch.float32, path
        served = model.init(0)
        for (path, a), (_, b) in zip(leaves(masters), leaves(served)):
            want = torch.float32 if path.rsplit(".", 1)[-1] in f32 else torch.bfloat16
            assert b.dtype == want, path
            assert torch.equal(a.to(b.dtype), b), path
        # init's zero conv kernel gives the RG-LRU gates no gradient: redraw
        host = redraw_constants(tree_map(lambda t: t.numpy(), masters),
                                np.random.default_rng(0))
        masters = params_from_jax(cfg, host, device="cpu", masters=True)
        flat = [t.requires_grad_(True) for _, t in leaves(masters)]
        batch = to_port(batch_np(cfg, 0))
        grads = torch.autograd.grad(model.train_loss(masters, batch), flat)
        for (path, _), g in zip(leaves(masters), grads):
            assert g.dtype == torch.float32, path
            if path.rsplit(".", 1)[-1] in f32:
                assert bool(g.abs().max() > 0), path


def test_params_from_jax_keeps_float32_masters(cases):
    case = cases("rwkv6-1.6b")
    cfg = get_reduced("rwkv6-1.6b")
    masters = params_from_jax(cfg, case["params"], device="cpu", masters=True)
    for (path, t), (_, a) in zip(leaves(masters), leaves(case["params"])):
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a), path


@pytest.mark.parametrize("name", ["qwen3-4b", "llama4-maverick-400b-a17b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "whisper-small"])
def test_remat_leaves_loss_and_gradients_to_the_bit(cases, name):
    case = cases(name)
    routes = case["routes"] or None
    on = port_case(case, routes=routes, remat=True)
    off = port_case(case, routes=routes, remat=False)
    assert torch.equal(on["loss"], off["loss"])
    for path, g in on["grads"].items():
        assert torch.equal(g, off["grads"][path]), path


def test_train_loss_refuses_tensors_on_another_device():
    cfg = get_reduced("qwen3-4b")
    model = get_model(cfg, device="cpu")
    params = model.init(0, masters=True)
    batch = to_port(batch_np(cfg, 0), device="meta")
    with pytest.raises(ValueError, match="on meta"):
        model.train_loss(params, batch)
