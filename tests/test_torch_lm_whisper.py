"""The port's whisper encoder-decoder against the JAX package's, on the CPU,
at the reduced ``whisper-small`` (2 encoder and 2 decoder layers, d_model
64, 4 heads padded to 4 × 1 over the model axis of 2).

JAX runs as ``tests/test_archs.py`` runs it (``jax.jit`` on the (1, 1)
mesh), compiled once for the module; its weights cross to the port through
``params_from_jax``.  ``init`` draws every bias as zeros and every
LayerNorm scale as ones, so the fixture redraws them (± 0.1 normals)
before both packages run.  Frames and tokens are drawn with numpy.

Bounds (the transformer family's): logits within 0.0625 (0.012 the largest seen over six
seeds), so equal argmaxes wherever JAX's top two logits are more than
0.125 apart; the first decoder layer's self-attention k/v within one bf16
ulp (equal in every run seen), its cross-attention xk/xv, projections of
the encoder's output after two layers, within two ulps at their largest
magnitude (0.031 seen at 3.8); every layer within 2^-4.
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
from repro.models import whisper as jax_whisper
from repro.models.registry import get_model as jax_get_model

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import count_params, get_model, param_shapes, params_from_jax
from repro_torch.models import whisper

NAME = "whisper-small"
B, S, STEPS = 2, 32, 6
LOGIT_ATOL = 0.0625
ULP = 2.0 ** -7


def _redraw(tree, rng):
    """JAX's tree with the biases and LayerNorm scales as seeded normals."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng)
            continue
        a = np.asarray(v, np.float32)
        if np.all(a == 0) or np.all(a == 1):
            a = (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        out[k] = a
    return out


@pytest.fixture(scope="module")
def jx(mesh11):
    """JAX's prefill and STEPS decode steps on redrawn weights."""
    cfg = jax_get_reduced(NAME)
    model = jax_get_model(cfg)
    rng = np.random.default_rng(0)
    params = _redraw(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0))), rng)
    jp = jax.tree.map(jnp.asarray, params)
    frames = rng.normal(size=(B, S // cfg.frontend_len_div, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    with compat.set_mesh(mesh11):
        logits, cache = jax.jit(lambda p, b: model.prefill(p, b))(
            jp, {"frames": jnp.asarray(frames, jnp.bfloat16), "tokens": jnp.asarray(tokens)})
        cache = dict(cache)
        for n in ("k", "v"):  # the JAX serve CLI grows the self-attention cache only
            cache[n] = jnp.pad(cache[n], ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)))
        step = jax.jit(lambda p, c, t, pos: model.decode_step(mesh11, p, c, t, pos))
        rows, caches, fed = [np.asarray(logits, np.float32)], [cache], []
        for i in range(STEPS):
            tok = jnp.argmax(logits[:, : cfg.vocab], -1).astype(jnp.int32)
            fed.append(np.asarray(tok))
            logits, cache = step(jp, cache, tok, jnp.asarray(S + i, jnp.int32))
            rows.append(np.asarray(logits, np.float32))
            caches.append(cache)
    return {"cfg": cfg, "params": params, "frames": frames, "tokens": tokens, "fed": fed,
            "logits": np.stack(rows)[..., : cfg.vocab],
            "caches": [jax.tree.map(lambda x: np.asarray(x, np.float32), c) for c in caches]}


def _batch(frames, tokens):
    return {"frames": torch.from_numpy(frames).to(torch.bfloat16),
            "tokens": torch.from_numpy(tokens).long()}


@pytest.fixture(scope="module")
def port(jx):
    """The port on JAX's weights, fed JAX's frames, prompt and tokens; the
    cross-attention cache is kept bit for bit after every step."""
    cfg = get_reduced(NAME)
    model = get_model(cfg, device="cpu")
    params = params_from_jax(cfg, jx["params"], device="cpu")
    snap = lambda c: {k: v.float().numpy().copy()  # noqa: E731
                      if isinstance(v, torch.Tensor) else v for k, v in c.items()}
    logits, cache = model.prefill(params, _batch(jx["frames"], jx["tokens"]), max_seq=S + STEPS)
    rows, caches, cross = [logits.numpy()], [snap(cache)], []
    for tok in jx["fed"]:
        before = (cache["xk"].clone(), cache["xv"].clone())
        logits, cache = model.decode_step(params, cache, torch.from_numpy(np.array(tok)).long())
        cross.append(torch.equal(before[0], cache["xk"]) and torch.equal(before[1], cache["xv"]))
        rows.append(logits.numpy())
        caches.append(snap(cache))
    return {"cfg": cfg, "model": model, "params": params, "cross_unchanged": cross,
            "logits": np.stack(rows)[..., : cfg.vocab], "caches": caches}


def test_prefill_and_decode_logits_match_jax(jx, port):
    got, want = port["logits"], jx["logits"]
    assert got.shape == want.shape == (STEPS + 1, B, port["cfg"].vocab)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * LOGIT_ATOL
    assert clear.any() and np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


@pytest.mark.parametrize("at", [0, STEPS], ids=["prefill", "decode"])
def test_caches_match_jax(jx, port, at):
    j, p = jx["caches"][at], port["caches"][at]
    assert p["length"] == S + at and set(p) == set(j)
    for n in ("k", "v", "xk", "xv"):
        assert p[n].shape == j[n].shape, n
        if n in ("k", "v"):
            np.testing.assert_allclose(p[n][0], j[n][0], rtol=ULP, atol=ULP, err_msg=n)
        else:
            spacing = 2.0 ** (np.floor(np.log2(np.abs(j[n][0]).max())) - 7)
            assert np.abs(p[n][0] - j[n][0]).max() <= 2 * spacing, n
        np.testing.assert_allclose(p[n], j[n], rtol=0, atol=2.0 ** -4, err_msg=n)
    assert not np.any(p["k"][:, :, S + at:])  # slots past the position stay empty


def test_decode_leaves_the_cross_cache_unchanged(port):
    """Cross-attention reads the encoder's k/v (``flash_decode(write=False)``):
    every decode step leaves xk and xv as they were, bit for bit."""
    assert port["cross_unchanged"] == [True] * STEPS


def test_decode_matches_prefill(port, jx):
    """The port's own contract: decode at position S equals a fresh prefill
    over S+1 tokens with the same frames."""
    cfg, model, params = port["cfg"], port["model"], port["params"]
    batch = _batch(jx["frames"], jx["tokens"])
    logits, cache = model.prefill(params, batch, max_seq=S + 1)
    tok = torch.argmax(logits[:, : cfg.vocab], -1)
    dec, _ = model.decode_step(params, cache, tok)
    full, _ = model.prefill(params, {**batch, "tokens": torch.cat([batch["tokens"],
                                                                   tok[:, None]], 1)})
    a, b = dec[:, : cfg.vocab].numpy(), full[:, : cfg.vocab].numpy()
    assert np.mean(a.argmax(-1) == b.argmax(-1)) >= 0.95
    np.testing.assert_allclose(a, b, atol=0.15, rtol=0.1)


def test_the_two_sinusoids_are_jax_s():
    """Prefill's table (float64, then float32) equals JAX's to the bit;
    decode's float32 position vector equals JAX's within an f32 ulp at the
    angle, and the two differ in the last bits as in JAX."""
    D = get_reduced(NAME).d_model
    np.testing.assert_array_equal(whisper._sinusoid(40, D).numpy(),
                                  np.asarray(jax_whisper._sinusoid(40, D)))
    for pos in (0, 7, 33, 511):
        got = whisper._sin_at(pos, D, "cpu").numpy()
        want = np.asarray(jax_whisper._sin_at(jnp.asarray(pos, jnp.int32), D))
        np.testing.assert_allclose(got, want, rtol=0, atol=pos * 2.0 ** -23 + 2.0 ** -24)
        np.testing.assert_allclose(got, whisper._sinusoid(512, D).numpy()[pos], rtol=0,
                                   atol=pos * 2.0 ** -22 + 2.0 ** -23)


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
        want, _ = jax_get_model(jax_cfg).abstract_cache(B, 40, enc_seq=16)
        got = get_model(port_cfg, device="cpu").alloc_cache(B, 40, enc_seq=16)
        for n in ("k", "v", "xk", "xv"):
            assert tuple(got[n].shape) == want[n].shape and got[n].dtype == torch.bfloat16
    full = get_config(NAME)
    assert full.padded_vocab == 51_968 and full.padded_heads == (16, 1)
    assert count_params(param_shapes(full)) == 266_692_608


def test_params_from_jax_refuses_a_misshapen_tree(jx):
    cfg = get_reduced(NAME)
    bad = jax.tree.map(lambda x: x, jx["params"])
    bad["dec"]["x_bq"] = bad["dec"]["x_bq"][:, :-1]
    with pytest.raises(ValueError, match="x_bq: shape"):
        params_from_jax(cfg, bad, device="cpu")
    bad["dec"] = {k: v for k, v in jx["params"]["dec"].items() if k != "lnx_b"}
    with pytest.raises(ValueError, match="names"):
        params_from_jax(cfg, bad, device="cpu")
