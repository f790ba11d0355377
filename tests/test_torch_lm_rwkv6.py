"""The port's RWKV-6 against the JAX package's, on the CPU, at the reduced
``rwkv6-1.6b`` (2 layers, d_model 64, 4 heads of 16).

JAX runs as ``tests/test_archs.py`` runs it (``jax.jit`` on the (1, 1)
mesh), compiled once for the module; its weights cross to the port through
``params_from_jax``.  ``init`` draws the token-shift mixes, the decay
offset ``w0``, the bonus ``u`` and the head groupnorm's bias as zeros and
its scale as ones, so the fixture redraws them as seeded normals (the
mixes uniform in [0, 1]) before both packages run.

Bounds, from the readings over six seeds of this harness (port against
JAX, prefill and 6 decode steps, at prompts of 32 and of 80 tokens):

- Logits within ``LOGIT_ATOL`` = 0.125 (largest seen 0.102), so equal
  argmaxes wherever JAX's top two logits are more than 2 × 0.125 apart.
  The transformer family's 0.0625 does not hold: JAX's own program,
  compiled with XLA's default and with ``xla_allow_excess_precision``
  off, differs from itself by 0.055-0.066 on these weights, and the port
  sits as far from either.
- The first layer's ``xt`` carry within one bf16 ulp (rtol and atol 2^-7;
  equal in every run seen), its ``xc`` within two (2^-6; one layer's
  output rounds in between); its float32 WKV state ``s`` within 1e-4 of its
  largest magnitude (1.6e-5 seen).  Every layer's xt/xc within
  ``LAYER_REL`` = 2^-4 of that layer's largest magnitude (0.022 seen;
  magnitudes 2-4, so the transformer family's 2^-4 at magnitude ~1 scaled
  to these carries) and within ``LAYER_ATOL`` = 2^-3 (0.0625 seen), its
  ``s`` within ``S_LAYER_REL`` = 2^-5 of its largest magnitude (0.013).
- An 80-token prompt (past ``CHUNK`` = 64, a full WKV chunk and a partial
  one) under the same bounds (logits 0.090 seen).
- One block against JAX's ``_block`` compiled with excess precision off
  (JAX's arithmetic as written): ``s`` within ``S_REL`` = 1e-5 relative
  (9e-8 seen), ``xt`` equal, ``xc`` and the output within one bf16 ulp at
  their largest magnitude.  The WKV output and the head groupnorm, float32 both, within
  ``F32_REL`` = 1e-6 relative (2e-7 seen); any of the four f32 entries
  stored in bf16 moves the float32 quantity it enters by 1.1e-4 to 2.8e-3,
  more than ten times that: the f32 test.
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
from repro.models import rwkv6 as jax_rwkv6
from repro.models.registry import get_model as jax_get_model

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import count_params, get_model, param_shapes, params_from_jax
from repro_torch.models import rwkv6

NAME = "rwkv6-1.6b"
B, S, STEPS = 2, 32, 6
LONG = 80  # a prompt past one WKV chunk
LOGIT_ATOL = 0.125
ULP = 2.0 ** -7
LAYER_REL, LAYER_ATOL, S_LAYER_REL = 2.0 ** -4, 2.0 ** -3, 2.0 ** -5
S_L0_REL, S_REL, F32_REL = 1e-4, 1e-5, 1e-6
NO_EXCESS = {"xla_allow_excess_precision": False}


def _redraw(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: _redraw(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if key.startswith("mu_"):
        return rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
    if key == "w0":
        return rng.normal(-2.0, 1.0, a.shape).astype(np.float32)
    if key == "u":
        return rng.normal(0.0, 0.5, a.shape).astype(np.float32)
    if key == "ln_x":
        return (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    if key == "ln_x_b":
        return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
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

    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    logits, caches, fed = run(tokens, STEPS)
    return {"cfg": cfg, "params": params, "tokens": tokens, "fed": fed, "logits": logits,
            "caches": caches, "run": run}


@pytest.fixture(scope="module")
def port(jx):
    """The port on JAX's weights, fed JAX's prompt and tokens."""
    cfg = get_reduced(NAME)
    model = get_model(cfg, device="cpu")
    params = params_from_jax(cfg, jx["params"], device="cpu")
    snap = lambda c: {k: v.float().numpy().copy()  # noqa: E731
                      if isinstance(v, torch.Tensor) else v for k, v in c.items()}

    def run(tokens, fed):
        """The port's logits and caches, fed JAX's tokens."""
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens).long()})
        rows, caches = [logits.numpy()], [snap(cache)]
        for tok in fed:
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(np.array(tok)).long())
            rows.append(logits.numpy())
            caches.append(snap(cache))
        return np.stack(rows)[..., : cfg.vocab], caches

    logits, caches = run(jx["tokens"], jx["fed"])
    return {"cfg": cfg, "model": model, "params": params, "logits": logits, "caches": caches,
            "run": run}


def _logits_agree(got, want):
    """Within ``LOGIT_ATOL``, so the argmax is equal wherever JAX's top two
    logits are more than 2 × that apart (checked on those rows)."""
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * LOGIT_ATOL
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def _states_agree(j, p, first_layer=True):
    """Every layer's xt/xc within ``LAYER_REL`` of that layer's largest
    magnitude and within ``LAYER_ATOL``, its WKV state ``s`` within
    ``S_LAYER_REL`` of its largest magnitude; with
    ``first_layer``, the first layer's xt within one bf16 ulp, xc within
    two and s within ``S_L0_REL``."""
    for n in ("xt", "xc"):
        assert p[n].shape == j[n].shape
        if first_layer:
            one = ULP if n == "xt" else 2 * ULP
            np.testing.assert_allclose(p[n][0], j[n][0], rtol=one, atol=one)
        for a, b in zip(j[n], p[n]):
            assert np.abs(a - b).max() <= min(LAYER_ATOL, LAYER_REL * np.abs(a).max()), n
    if first_layer:
        a, b = j["s"][0], p["s"][0]
        assert np.abs(a - b).max() <= S_L0_REL * np.abs(a).max()
    for a, b in zip(j["s"], p["s"]):
        assert np.abs(a - b).max() <= S_LAYER_REL * np.abs(a).max()


def test_prefill_and_decode_logits_match_jax(jx, port):
    got, want = port["logits"], jx["logits"]
    assert got.shape == want.shape == (STEPS + 1, B, port["cfg"].vocab)
    _logits_agree(got, want)


@pytest.mark.parametrize("at", [0, STEPS], ids=["prefill", "decode"])
def test_carried_state_matches_jax(jx, port, at):
    j, p = jx["caches"][at], port["caches"][at]
    assert p["length"] == S + at and set(p) == set(j)
    assert j["s"].shape == p["s"].shape == (2, B, 4, 16, 16)
    _states_agree(j, p)


def test_a_prompt_past_one_chunk_matches_jax(jx, port):
    """An 80-token prompt, past ``CHUNK`` = 64, so the port's WKV runs a full
    chunk and a partial one (JAX's pads the second with w = 1): prefill and
    4 decode steps within the logit bound, every layer's state after prefill
    and after the last step within the per-layer bounds."""
    assert LONG > rwkv6.CHUNK == jax_rwkv6.CHUNK
    tokens = np.random.default_rng(5).integers(
        0, jx["cfg"].vocab, size=(B, LONG)).astype(np.int32)
    jl, jc, fed = jx["run"](tokens, 4)
    pl, pc = port["run"](tokens, fed)
    _logits_agree(pl, jl)
    for at in (0, -1):
        _states_agree(jc[at], pc[at])


# ------------------------------------------------------------- one block, f32
def _first_block(jx, port, store_bf16=(), steps=(S, 1)):
    """JAX's ``_block`` (excess precision off) and the port's on the first
    layer: a prefill of S tokens, then one step from the state it leaves."""
    cfg = port["cfg"]
    lp_j = {k: jnp.asarray(v[0]) for k, v in jx["params"]["layers"].items()}
    lp_p = {k: v[0] for k, v in port["params"]["layers"].items()}
    lp_p = {k: v.to(torch.bfloat16).float() if k in store_bf16 else v for k, v in lp_p.items()}
    fn = jax.jit(lambda lp, x, s, xt, xc: jax_rwkv6._block(jx["cfg"], x, lp, s, xt, xc),
                 compiler_options=NO_EXCESS)
    rng = np.random.default_rng(1)
    H, dh = cfg.d_model // cfg.head_dim, cfg.head_dim
    sj = jnp.zeros((B, H, dh, dh), jnp.float32)
    xtj = xcj = jnp.zeros((B, cfg.d_model), jnp.bfloat16)
    sp = torch.zeros((B, H, dh, dh))
    xtp = xcp = torch.zeros((B, cfg.d_model), dtype=torch.bfloat16)
    out = []
    for n in steps:
        x = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
        oj, sj, xtj, xcj = fn(lp_j, jnp.asarray(x, jnp.bfloat16), sj, xtj, xcj)
        op, sp, xtp, xcp = rwkv6._block(cfg, lp_p, torch.from_numpy(x).to(torch.bfloat16),
                                        sp, xtp, xcp)
        out.append({n_: (np.asarray(jnp.asarray(a).astype(jnp.float32)), b.float().numpy())
                    for n_, a, b in (("out", oj, op), ("s", sj, sp), ("xt", xtj, xtp),
                                     ("xc", xcj, xcp))})
    return out


def _ulps(a, b):
    """max|a - b| in units of bf16's spacing at max|a| (the rounding of a
    sum is at the scale of its terms, not of its result)."""
    return float(np.abs(a - b).max() / 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7))


def _within(r):
    """Whether one block's results hold the as-written bounds."""
    a, b = r["s"]
    return (np.abs(a - b).max() <= S_REL * np.abs(a).max() and np.array_equal(*r["xt"])
            and _ulps(*r["xc"]) <= 1 and _ulps(*r["out"]) <= 1)


def test_one_block_equals_jax_as_written(jx, port):
    """Against JAX compiled with excess precision off, prefill form and one
    decode step: s to float32 precision, xt equal, xc and the output within
    one bf16 ulp at their largest magnitude (torch rounds SiLU and the
    groupnorm's cast once where JAX's bf16 ops round in turn)."""
    for r in _first_block(jx, port):
        assert _within(r), {k: _ulps(a, b) for k, (a, b) in r.items()}


def _f32_paths(jx, port, store_bf16=()):
    """Relative max|Δ| against JAX (excess precision off) of the float32
    quantity each f32 entry enters: the first block's WKV state (``w0``),
    the WKV output (``u``) and the head groupnorm's output (``ln_x``,
    ``ln_x_b``), on the first layer's entries."""
    cfg = port["cfg"]
    H, dh = cfg.d_model // cfg.head_dim, cfg.head_dim
    lp_j = {k: jnp.asarray(v[0]) for k, v in jx["params"]["layers"].items()}
    lp_p = {k: v[0] for k, v in port["params"]["layers"].items()}
    lp_p = {k: v.to(torch.bfloat16).float() if k in store_bf16 else v for k, v in lp_p.items()}
    rng = np.random.default_rng(2)
    rkv = rng.normal(size=(3, B, S, H, dh)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, size=(B, S, H, dh)).astype(np.float32)
    y = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    s0 = np.zeros((B, H, dh, dh), np.float32)
    yj, _ = jax.jit(lambda u, r, k, v, w: jax_rwkv6.wkv(r, k, v, w, u, jnp.asarray(s0)),
                    compiler_options=NO_EXCESS)(lp_j["u"], *jnp.asarray(rkv, jnp.bfloat16), w)
    yp, _ = rwkv6.wkv(*torch.from_numpy(rkv).to(torch.bfloat16), torch.from_numpy(w),
                      lp_p["u"].float(), torch.from_numpy(s0))
    gj = jax.jit(jax_rwkv6._head_groupnorm, compiler_options=NO_EXCESS)(
        jnp.asarray(y), lp_j["ln_x"], lp_j["ln_x_b"])
    gp = rwkv6._head_groupnorm(torch.from_numpy(y), lp_p["ln_x"], lp_p["ln_x_b"])
    rel = lambda a, b: float(np.abs(np.asarray(a) - b.numpy()).max()  # noqa: E731
                             / np.abs(np.asarray(a)).max())
    (sj, sp) = _first_block(jx, port, store_bf16, steps=(S,))[0]["s"]
    return {"state": float(np.abs(sj - sp).max() / np.abs(sj).max()),
            "wkv": rel(yj, yp), "groupnorm": rel(gj, gp)}


def test_f32_paths_equal_jax_as_written(jx, port):
    """Where each f32 entry enters, the port is JAX's to float32 precision."""
    for path, rel in _f32_paths(jx, port).items():
        assert rel <= F32_REL, (path, rel)


@pytest.mark.parametrize("name", sorted(rwkv6.F32_ENTRIES))
def test_f32_entries_stay_f32_and_matter(jx, port, name):
    """w0, u, ln_x and ln_x_b are float32 in ``init`` and ``params_from_jax``;
    stored in bf16, the float32 path it enters leaves JAX's by >10× the
    bound."""
    for tree in (port["params"], get_model(port["cfg"], device="cpu").init(0)):
        for k, t in tree["layers"].items():
            assert t.dtype == (torch.float32 if k in rwkv6.F32_ENTRIES else torch.bfloat16), k
    assert max(_f32_paths(jx, port, store_bf16=(name,)).values()) > 10 * F32_REL


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


def test_wkv_chunks_do_not_change_the_result(jx, port, monkeypatch):
    """The WKV's chunking only batches the outer products: a prompt longer
    than one chunk gives the state a chunk-free loop gives."""
    model, params = port["model"], port["params"]
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, port["cfg"].vocab,
                                                                size=(1, 70)))
    la, ca = model.prefill(params, {"tokens": tokens})
    monkeypatch.setattr(rwkv6, "CHUNK", 1)
    lb, cb = model.prefill(params, {"tokens": tokens})
    assert torch.equal(la, lb) and torch.equal(ca["s"], cb["s"])


# ------------------------------------------------------------ configs, shapes
def test_config_and_param_shapes_equal_jax():
    from repro.launch.dryrun import count_params as jax_count_params

    for port_cfg, jax_cfg in ((get_config(NAME), jax_get_config(NAME)),
                              (get_reduced(NAME), jax_get_reduced(NAME))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
        shapes, _ = jax_get_model(jax_cfg).abstract_init()
        mine = param_shapes(port_cfg)
        assert mine == {t: {k: v.shape for k, v in shapes[t].items()} for t in shapes}
        assert count_params(mine) == jax_count_params(shapes)
        cache, _ = jax_get_model(jax_cfg).abstract_cache(B, 1)
        fresh = rwkv6.alloc_cache(port_cfg, B, 1, "meta")
        for n in ("s", "xt", "xc"):
            assert tuple(fresh[n].shape) == cache[n].shape
            assert str(fresh[n].dtype).split(".")[-1] == str(cache[n].dtype)
    assert count_params(param_shapes(get_config(NAME))) == 1_583_941_632


def test_params_from_jax_refuses_a_misshapen_tree(jx):
    cfg = get_reduced(NAME)
    bad = jax.tree.map(lambda x: x, jx["params"])
    bad["layers"]["u"] = bad["layers"]["u"][:, :, :-1]
    with pytest.raises(ValueError, match="u: shape"):
        params_from_jax(cfg, bad, device="cpu")
    bad = {"top": jx["params"]["top"]}
    with pytest.raises(ValueError, match="names"):
        params_from_jax(cfg, bad, device="cpu")
