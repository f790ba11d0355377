"""The port's RecurrentGemma hybrid (RG-LRU + local attention) against the
JAX package's, on the CPU, at the reduced ``recurrentgemma-9b``
(5 layers: (rglru, rglru, attn) + (rglru, rglru), window 16).

JAX runs as ``tests/test_archs.py`` runs it (``jax.jit`` on the (1, 1)
mesh), compiled once for the module; its weights cross to the port through
``params_from_jax``.  ``init`` draws the conv kernel as zeros (which makes
the recurrent branch zero) and Λ and the gates as ones and zeros, so the
fixture redraws those entries as seeded normals before both packages run.

Bounds, from the readings over six seeds of this harness (port against
JAX, prefill and 6 decode steps):

- Logits within ``LOGIT_ATOL`` = 0.25 (largest seen 0.211), so equal
  argmaxes wherever JAX's top two logits are more than 2 × 0.25 apart;
  rows closer than that agreed on 90-100 % of rows.  The transformer
  family's 0.0625 does not hold here, and cannot: JAX's own program,
  compiled once with XLA's default (which may keep a fused chain of bf16
  operations in float32) and once with ``xla_allow_excess_precision`` off,
  differs from itself by 0.088-0.180 on these weights.
- The first layer's conv carry within one bf16 ulp (rtol and atol 2^-7);
  its float32 ``lru`` state within 1e-2 of its largest magnitude (4.1e-3
  seen: XLA rounds the gate chain differently inside its fusion).  Every
  layer's carries (conv, ring k/v, ``lru``) within ``LAYER_REL`` = 2^-4
  of that layer's largest magnitude (0.047 seen; the bf16 carries have
  magnitudes 2-5, so this is the transformer family's 2^-4 at magnitude
  ~1 scaled to them), the bf16 ones also within ``LAYER_ATOL`` = 2^-2
  (0.143 seen), in the ring-buffer test too.
- One block of each kind against JAX's compiled with excess precision off
  (JAX's arithmetic as written, every bf16 cast rounding): the RG-LRU's
  lru state within ``LRU_REL`` = 1e-6 relative (8e-8 seen), its conv
  carry equal, its output and the attention block's within one bf16 ulp,
  the ring written at the same slot.  Λ or a gate stored in bf16 moves the
  lru state by 2.6e-4 to 4.2e-4 relative: the f32 test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import compat
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import rglru as jax_rglru
from repro.models.registry import get_model as jax_get_model

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import count_params, get_model, param_shapes, params_from_jax
from repro_torch.models import rglru

NAME = "recurrentgemma-9b"
B, S, STEPS = 2, 32, 6
LOGIT_ATOL = 0.25
ULP = 2.0 ** -7
LRU_L0_REL, LRU_REL = 1e-2, 1e-6
LAYER_REL, LAYER_ATOL = 2.0 ** -4, 2.0 ** -2
NO_EXCESS = {"xla_allow_excess_precision": False}


def _redraw(tree, rng, key=None):
    """JAX's tree with the conv kernel, Λ and the gates as seeded normals."""
    if isinstance(tree, dict):
        return {k: _redraw(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_redraw(v, rng, key) for v in tree]
    a = np.asarray(tree, np.float32)
    if key == "conv":
        return rng.normal(0.0, 0.5, a.shape).astype(np.float32)
    if key in rglru.F32_ENTRIES:
        return rng.normal(0.0, 1.0, a.shape).astype(np.float32)
    return a


@pytest.fixture(scope="module")
def jx(mesh11):
    """JAX's reduced model on redrawn weights, prefill and decode jitted once."""
    cfg = jax_get_reduced(NAME)
    model = jax_get_model(cfg)
    rng = np.random.default_rng(0)
    params = _redraw(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0))), rng)
    jp = jax.tree.map(jnp.asarray, params)
    prefill = jax.jit(lambda p, b: model.prefill(p, b))
    step = jax.jit(lambda p, c, t, pos: model.decode_step(mesh11, p, c, t, pos))

    def run(tokens, steps):
        """JAX's logits (steps + 1, B, V), caches and fed tokens."""
        with compat.set_mesh(mesh11):
            logits, cache = prefill(jp, {"tokens": jnp.asarray(tokens)})
            rows, caches, fed = [np.asarray(logits, np.float32)], [cache], []
            for i in range(steps):
                tok = jnp.argmax(logits[:, : cfg.vocab], -1).astype(jnp.int32)
                fed.append(np.asarray(tok))
                logits, cache = step(jp, cache, tok, jnp.asarray(tokens.shape[1] + i, jnp.int32))
                rows.append(np.asarray(logits, np.float32))
                caches.append(cache)
        f32 = lambda c: jax.tree.map(lambda x: np.asarray(x, np.float32), c)  # noqa: E731
        return np.stack(rows)[..., : cfg.vocab], [f32(c) for c in caches], fed

    return {"cfg": cfg, "params": params, "run": run, "rng": rng}


@pytest.fixture(scope="module")
def port(jx):
    cfg = get_reduced(NAME)
    model = get_model(cfg, device="cpu")
    params = params_from_jax(cfg, jx["params"], device="cpu")

    def run(tokens, fed):
        """The port's logits and caches, fed JAX's tokens."""
        snap = lambda c: jax.tree.map(  # noqa: E731
            lambda x: x.float().numpy().copy() if isinstance(x, torch.Tensor) else x, c)
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens).long()})
        rows, caches = [logits.numpy()], [snap(cache)]
        for tok in fed:
            logits, cache = model.decode_step(params, cache, torch.from_numpy(np.array(tok)).long())
            rows.append(logits.numpy())
            caches.append(snap(cache))
        return np.stack(rows)[..., : cfg.vocab], caches

    return {"cfg": cfg, "model": model, "params": params, "run": run}


@pytest.fixture(scope="module")
def runs(jx, port):
    tokens = jx["rng"].integers(0, jx["cfg"].vocab, size=(B, S)).astype(np.int32)
    j_logits, j_caches, fed = jx["run"](tokens, STEPS)
    p_logits, p_caches = port["run"](tokens, fed)
    return {"j": (j_logits, j_caches), "p": (p_logits, p_caches)}


def _layers_agree(a, b, what, atol=np.inf):
    """Each layer (the leading axis) within ``LAYER_REL`` of its largest
    magnitude, and within ``atol``."""
    for r, (x, y) in enumerate(zip(a, b)):
        assert np.abs(x - y).max() <= min(atol, LAYER_REL * np.abs(x).max()), (what, r)


def _logits_agree(got, want, atol=LOGIT_ATOL):
    """Within ``atol``, so the argmax is equal wherever JAX's top two logits
    are more than 2 × atol apart (checked on those rows)."""
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * atol
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_prefill_and_decode_logits_match_jax(runs):
    (jl, _), (pl, _) = runs["j"], runs["p"]
    assert pl.shape == jl.shape == (STEPS + 1, B, get_reduced(NAME).vocab)
    _logits_agree(pl, jl)


@pytest.mark.parametrize("at", [0, STEPS], ids=["prefill", "decode"])
def test_carried_state_matches_jax(runs, at):
    """Every rglru layer's conv carry and lru state and the attention
    layer's ring buffer, after prefill and after the last decode step."""
    jc, pc = runs["j"][1][at], runs["p"][1][at]
    assert pc["length"] == S + at
    first = True
    for js, ps in zip(jc["segments"], pc["segments"]):
        for j, p in zip(js, ps):
            assert set(j) == set(p)
            for n in j:
                a, b = j[n], p[n]
                assert a.shape == b.shape, n
                if first and n == "lru":
                    assert np.abs(a[0] - b[0]).max() <= LRU_L0_REL * np.abs(a[0]).max()
                if first and n == "conv":
                    np.testing.assert_allclose(b[0], a[0], rtol=ULP, atol=ULP)
                _layers_agree(a, b, n, np.inf if n == "lru" else LAYER_ATOL)
            first = False


# ------------------------------------------------------------- one block, f32
def _first_block(jx, port, store_bf16=()):
    cfg = port["cfg"]
    lp_j = {k: jnp.asarray(v[0]) for k, v in jx["params"]["segments"][0][0].items()}
    lp_p = {k: v[0] for k, v in port["params"]["segments"][0][0].items()}
    lp_p = {k: v.to(torch.bfloat16).float() if k in store_bf16 else v for k, v in lp_p.items()}
    rng = np.random.default_rng(1)
    h = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    fn = jax.jit(lambda lp, h, cs, ls: jax_rglru._rglru_block(cfg, lp, h, cs, ls),
                 compiler_options=NO_EXCESS)
    j0 = jax.jit(lambda lp, h: jax_rglru._rglru_block(cfg, lp, h),
                 compiler_options=NO_EXCESS)(lp_j, jnp.asarray(h, jnp.bfloat16))
    ht = torch.from_numpy(h).to(torch.bfloat16)
    zero = torch.zeros((B, rglru.CONV_WIDTH - 1, rglru._d_rnn(cfg)), dtype=torch.bfloat16)
    p0 = rglru._rglru_block(cfg, lp_p, ht, zero)
    # one decode step from that state
    h1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    j1 = fn(lp_j, jnp.asarray(h1, jnp.bfloat16), j0[1], j0[2])
    p1 = rglru._rglru_block(cfg, lp_p, torch.from_numpy(h1).to(torch.bfloat16), p0[1], p0[2])
    return [(np.asarray(jnp.asarray(a).astype(jnp.float32)), b.float().numpy())
            for a, b in list(zip(j0, p0)) + list(zip(j1, p1))]


def test_one_block_equals_jax_as_written(jx, port):
    """Against JAX compiled with excess precision off: the conv carry equal,
    the lru state to float32 precision, the block output within one ulp;
    prefill form, then one decode step from its state."""
    for i, (a, b) in enumerate(_first_block(jx, port)):
        if i % 3 == 2:   # lru
            assert np.abs(a - b).max() <= LRU_REL * np.abs(a).max()
        elif i % 3 == 1:  # conv carry
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=ULP, atol=ULP)


@pytest.mark.parametrize("pos", [5, 40])
def test_attention_block_equals_jax_as_written(jx, port, pos):
    """The local-attention block over a full sequence, then one ring step at
    ``pos`` (inside the first window, then wrapped), against JAX's
    ``_attn_block_full`` and ``_attn_decode`` with excess precision off."""
    cfg, W = port["cfg"], port["cfg"].local_window
    lp_j = {k: jnp.asarray(v[0]) for k, v in jx["params"]["segments"][0][2].items()}
    lp_p = {k: v[0] for k, v in port["params"]["segments"][0][2].items()}
    hm_t, hm_j = cfg.head_mask().reshape(-1), jx["cfg"].head_mask().reshape(-1)
    rng = np.random.default_rng(pos)
    h = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    full = jax.jit(lambda lp, h: jax_rglru._attn_block_full(
        jx["cfg"], lp, h, jnp.arange(S, dtype=jnp.int32), hm_j), compiler_options=NO_EXCESS)
    oj, (kj, vj) = full(lp_j, jnp.asarray(h, jnp.bfloat16))
    op, kp, vp = rglru._attn_block_full(cfg, lp_p, torch.from_numpy(h).to(torch.bfloat16),
                                        torch.arange(S), hm_t)
    for a, b in ((oj, op), (kj, kp), (vj, vp)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   rtol=ULP, atol=ULP)
    ring = rng.normal(size=(2, B, W) + kp.shape[2:]).astype(np.float32)
    h1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    step = jax.jit(lambda lp, h, kc, vc, p: jax_rglru._attn_decode(jx["cfg"], lp, h, kc, vc, p,
                                                                   hm_j),
                   compiler_options=NO_EXCESS)
    oj, kcj, vcj = step(lp_j, jnp.asarray(h1, jnp.bfloat16), jnp.asarray(ring[0], jnp.bfloat16),
                        jnp.asarray(ring[1], jnp.bfloat16), jnp.asarray(pos, jnp.int32))
    kc, vc = (torch.from_numpy(r).to(torch.bfloat16) for r in ring)
    op = rglru._attn_decode(cfg, lp_p, torch.from_numpy(h1).to(torch.bfloat16), kc, vc, pos,
                            hm_t)
    np.testing.assert_allclose(op.float().numpy(), np.asarray(oj, np.float32), rtol=ULP,
                               atol=ULP)
    for a, b, r in ((kcj, kc, ring[0]), (vcj, vc, ring[1])):  # one slot written, pos % W
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=ULP,
                                   atol=ULP)
        before = r.astype(jnp.bfloat16).astype(np.float32)
        changed = np.any(b.float().numpy() != before, axis=(0, 2, 3))
        assert changed.tolist() == [j == pos % W for j in range(W)]


@pytest.mark.parametrize("name", sorted(rglru.F32_ENTRIES))
def test_f32_entries_stay_f32_and_matter(jx, port, name):
    """Λ and the gates are float32 in ``init`` and ``params_from_jax``; stored
    in bf16, the first block's lru state leaves JAX's by >100× the bound."""
    for tree in (port["params"], get_model(port["cfg"], device="cpu").init(0)):
        for seg in tree["segments"]:
            for pos in seg:
                for k, t in pos.items():
                    want = torch.float32 if k in rglru.F32_ENTRIES else torch.bfloat16
                    assert t.dtype == want, k
    a, b = _first_block(jx, port, store_bf16=(name,))[2]
    assert np.abs(a - b).max() > 100 * LRU_REL * np.abs(a).max()


# ------------------------------------------------------------- ring buffer
@pytest.mark.parametrize("prompt", [10, 32, 37])
def test_ring_buffer_decode_past_two_windows(jx, port, prompt):
    """Window 16: a prompt shorter than the window (padded), a multiple of it
    (roll by 0) and not (roll by 5); then 24 decode steps, past 2W, each
    step's logits against JAX; the ring's slots against JAX's at the end."""
    tokens = np.random.default_rng(prompt).integers(
        0, jx["cfg"].vocab, size=(B, prompt)).astype(np.int32)
    jl, jc, fed = jx["run"](tokens, 24)
    pl, pc = port["run"](tokens, fed)
    assert prompt + 24 > 2 * jx["cfg"].local_window
    _logits_agree(pl, jl)
    for s in (0, -1):
        ring_j, ring_p = jc[s]["segments"][0][2], pc[s]["segments"][0][2]
        for n in ("k", "v"):
            assert ring_p[n].shape[2] == jx["cfg"].local_window
            _layers_agree(ring_j[n], ring_p[n], n, LAYER_ATOL)
            # the slots hold the same positions: a zero slot is zero in both
            assert np.array_equal(ring_p[n] == 0, ring_j[n] == 0)


def test_decode_matches_prefill(port):
    """The port's own contract (``test_archs.py``'s): decode at position S
    equals a fresh prefill over S+1 tokens."""
    cfg, model, params = port["cfg"], port["model"], port["params"]
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, size=(B, S)))
    logits, cache = model.prefill(params, {"tokens": tokens})
    tok = torch.argmax(logits[:, : cfg.vocab], -1)
    dec, _ = model.decode_step(params, cache, tok)
    full, _ = model.prefill(params, {"tokens": torch.cat([tokens, tok[:, None]], 1)})
    a, b = dec[:, : cfg.vocab].numpy(), full[:, : cfg.vocab].numpy()
    assert np.mean(a.argmax(-1) == b.argmax(-1)) >= 0.95
    np.testing.assert_allclose(a, b, atol=0.15, rtol=0.1)


# ------------------------------------------------------------ configs, shapes
def test_config_and_param_shapes_equal_jax():
    from repro.launch.dryrun import count_params as jax_count_params

    for port_cfg, jax_cfg in ((get_config(NAME), jax_get_config(NAME)),
                              (get_reduced(NAME), jax_get_reduced(NAME))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
        shapes, _ = jax_get_model(jax_cfg).abstract_init()
        mine = param_shapes(port_cfg)
        assert mine["top"] == {k: v.shape for k, v in shapes["top"].items()}
        assert mine["segments"] == [[{k: v.shape for k, v in pos.items()} for pos in seg]
                                    for seg in shapes["segments"]]
        assert count_params(mine) == jax_count_params(shapes)
        assert rglru.segments(port_cfg) == jax_rglru.segments(jax_cfg)
    assert count_params(param_shapes(get_config(NAME))) == 9_572_462_592


def test_cache_shapes_equal_jax(runs):
    jc, pc = runs["j"][1][0], runs["p"][1][0]
    shapes, _ = jax_get_model(jax_get_reduced(NAME)).abstract_cache(B, 1)
    fresh = get_model(get_reduced(NAME), device="cpu").alloc_cache(B, 1)
    for js, ps, fs, ss in zip(jc["segments"], pc["segments"], fresh["segments"],
                              shapes["segments"]):
        for j, p, f, s in zip(js, ps, fs, ss):
            for n in s:
                assert j[n].shape == p[n].shape == tuple(f[n].shape) == s[n].shape
                assert f[n].dtype == (torch.float32 if n == "lru" else torch.bfloat16)


def test_params_from_jax_refuses_a_misshapen_tree(jx):
    cfg = get_reduced(NAME)
    bad = jax.tree.map(lambda x: x, jx["params"])
    bad["segments"][0][0]["gate_r"] = bad["segments"][0][0]["gate_r"][:, :-1]
    with pytest.raises(ValueError, match="gate_r"):
        params_from_jax(cfg, bad, device="cpu")
    bad = {"top": jx["params"]["top"], "segments": jx["params"]["segments"][:1]}
    with pytest.raises(ValueError, match="entries"):
        params_from_jax(cfg, bad, device="cpu")
