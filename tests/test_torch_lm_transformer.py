"""The port's transformer family (dense, MoE, VLM) against the JAX package's,
on the CPU, at the 7 reduced configurations; and the port's own serving
contracts.

JAX runs as ``tests/test_archs.py`` runs it (``jax.jit`` on the (1, 1)
mesh); its weights cross to the port through ``params_from_jax``, and the
prompt (and a VLM's patch embeddings) are drawn with numpy.  One module
fixture a architecture compiles JAX once.

Bounds against JAX (bf16 activations in both packages; XLA may keep
excess precision inside a fusion where torch rounds each op): prefill and
decode logits within ``LOGIT_ATOL`` = 0.0625 (four bf16 ulps at the
logits' magnitude, 2-4; the largest seen is 0.0547, llava-next-34b's
decode) with equal argmaxes.  The first group's k/v cache: its first
layer within one bf16 ulp (atol and rtol 2^-7; llava-next-34b's largest
difference is 2^-7), every layer within 2^-4 (the second layer's inputs
differ by the first's rounding; 0.039 seen at olmoe-1b-7b, after a MoE
layer).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models.registry import get_model as jax_get_model

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.launch import serve
from repro_torch.models import count_params, get_model, param_shapes, params_from_jax

B, S, GROW = 2, 32, 8
TRANSFORMER = [n for n in ARCHS if get_reduced(n).family in ("dense", "moe", "vlm")]
LOGIT_ATOL = 0.0625
KV_ULP, KV_ATOL = 2.0 ** -7, 2.0 ** -4


def _prompt(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch, n_text = {}, S
    if cfg.family == "vlm":
        pe = S // cfg.frontend_len_div
        n_text = S - pe
        batch["embeds"] = rng.normal(size=(B, pe, cfg.d_model)).astype(np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab, size=(B, n_text)).astype(np.int32)
    return batch


def _port_batch(batch):
    out = {"tokens": torch.from_numpy(batch["tokens"]).long()}
    if "embeds" in batch:
        out["embeds"] = torch.from_numpy(batch["embeds"]).to(torch.bfloat16)
    return out


def _jax_run(name, mesh):
    cfg = jax_get_reduced(name)
    model = jax_get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = _prompt(cfg)
    jb = {k: jnp.asarray(v, jnp.bfloat16 if k == "embeds" else jnp.int32)
          for k, v in batch.items()}
    with compat.set_mesh(mesh):
        logits, cache = jax.jit(lambda p, b: model.prefill(p, b))(params, jb)
        grown = jax.tree.map(
            lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, GROW), (0, 0), (0, 0)))
            if hasattr(x, "ndim") and x.ndim == 5 else x, cache)
        tok = jnp.argmax(logits[:, : cfg.vocab], -1).astype(jnp.int32)
        dec, _ = jax.jit(lambda p, c, t, pos: model.decode_step(mesh, p, c, t, pos))(
            params, grown, tok, jnp.asarray(S, jnp.int32))
    return {
        "params": jax.tree.map(np.asarray, params),
        "batch": batch,
        "logits": np.asarray(logits, np.float32),
        "k": np.asarray(cache["layers"][0]["k"].astype(jnp.float32)),
        "v": np.asarray(cache["layers"][0]["v"].astype(jnp.float32)),
        "tok": np.asarray(tok),
        "decode": np.asarray(dec, np.float32),
    }


@pytest.fixture(scope="module")
def runs(mesh11):
    """JAX's and the port's prefill and first decode step, one a arch."""
    done = {}

    def get(name):
        if name not in done:
            j = _jax_run(name, mesh11)
            cfg = get_reduced(name)
            model = get_model(cfg, device="cpu")
            params = params_from_jax(cfg, j["params"], device="cpu")
            logits, cache = model.prefill(params, _port_batch(j["batch"]), max_seq=S + GROW)
            kv = {n: cache["layers"][0][n][:, :, :S].float().numpy() for n in ("k", "v")}
            dec, _ = model.decode_step(params, cache, torch.tensor(j["tok"], dtype=torch.long))
            done[name] = (cfg, j, {"logits": logits.numpy(), **kv, "decode": dec.numpy(),
                                   "params": params, "model": model})
        return done[name]

    return get


def _logits_agree(got, want, vocab):
    got, want = got[:, :vocab], want[:, :vocab]
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("name", TRANSFORMER)
def test_prefill_logits_match_jax(runs, name):
    cfg, j, p = runs(name)
    assert p["logits"].shape == (B, cfg.padded_vocab)
    _logits_agree(p["logits"], j["logits"], cfg.vocab)
    assert np.all(p["logits"][:, cfg.vocab:] < -1e8)  # the vocab mask


@pytest.mark.parametrize("name", TRANSFORMER)
def test_first_group_kv_cache_matches_jax(runs, name):
    cfg, j, p = runs(name)
    for n in ("k", "v"):
        assert p[n].shape == j[n].shape
        np.testing.assert_allclose(p[n][0], j[n][0], rtol=KV_ULP, atol=KV_ULP)
        np.testing.assert_allclose(p[n], j[n], rtol=0, atol=KV_ATOL)


@pytest.mark.parametrize("name", TRANSFORMER)
def test_decode_step_matches_jax(runs, name):
    cfg, j, p = runs(name)
    _logits_agree(p["decode"], j["decode"], cfg.vocab)


def _decode_vs_prefill(cfg, params, model, batch):
    logits, cache = model.prefill(params, batch, max_seq=S + GROW)
    tok = torch.argmax(logits[:, : cfg.vocab], -1)
    dec, _ = model.decode_step(params, cache, tok)
    again = {**batch, "tokens": torch.cat([batch["tokens"], tok[:, None]], dim=1)}
    full, _ = model.prefill(params, again)
    return dec[:, : cfg.vocab].numpy(), full[:, : cfg.vocab].numpy()


@pytest.mark.parametrize("name", [n for n in TRANSFORMER if get_reduced(n).family != "moe"])
def test_decode_matches_prefill(runs, name):
    """The port's own autoregressive contract (``test_archs.py``'s): decode at
    position S equals a fresh prefill over S+1 tokens.  MoE is left out, as
    there: capacity drops differ between the two by JAX's semantics."""
    cfg, j, p = runs(name)
    a, b = _decode_vs_prefill(cfg, p["params"], p["model"], _port_batch(j["batch"]))
    assert np.mean(a.argmax(-1) == b.argmax(-1)) >= 0.95
    np.testing.assert_allclose(a, b, atol=0.15, rtol=0.1)


def test_int8_kv_cache_parity(runs):
    """The int8 cache (per-token-per-head scales) keeps decode's argmax and
    stays within 5 % relative of the bf16 cache (``test_archs.py``'s)."""
    cfg, j, p = runs("qwen3-4b")
    model8 = get_model(dataclasses.replace(cfg, kv_cache_dtype="int8"), device="cpu")
    batch = _port_batch(j["batch"])
    logits, cache = model8.prefill(p["params"], batch, max_seq=S + GROW)
    assert cache["layers"][0]["k"].dtype == torch.int8
    assert cache["layers"][0]["ks"].shape == cache["layers"][0]["k"].shape[:-1]
    tok = torch.argmax(logits[:, : cfg.vocab], -1)
    d8, _ = model8.decode_step(p["params"], cache, tok)
    logits, cache = p["model"].prefill(p["params"], batch, max_seq=S + GROW)
    d16, _ = p["model"].decode_step(p["params"], cache, tok)
    a, b = d16[:, : cfg.vocab].numpy(), d8[:, : cfg.vocab].numpy()
    assert (a.argmax(-1) == b.argmax(-1)).mean() == 1.0
    assert np.abs(a - b).max() / np.abs(a).max() < 0.05


# ------------------------------------------------------------ configs, shapes
@pytest.mark.parametrize("name", TRANSFORMER)
def test_configs_and_param_shapes_equal_jax(name):
    from repro.launch.dryrun import count_params as jax_count_params

    for port_cfg, jax_cfg in ((get_config(name), jax_get_config(name)),
                              (get_reduced(name), jax_get_reduced(name))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
        assert port_cfg.padded_heads == jax_cfg.padded_heads
        assert port_cfg.padded_vocab == jax_cfg.padded_vocab
        assert np.array_equal(port_cfg.head_mask().numpy(), np.asarray(jax_cfg.head_mask()))
        assert np.array_equal(port_cfg.vocab_mask().numpy(), np.asarray(jax_cfg.vocab_mask()))
        shapes, _ = jax_get_model(jax_cfg).abstract_init()
        mine = param_shapes(port_cfg)
        assert mine["top"] == {k: v.shape for k, v in shapes["top"].items()}
        assert mine["groups"] == [{k: v.shape for k, v in g.items()} for g in shapes["groups"]]
        assert count_params(mine) == jax_count_params(shapes)


def test_qwen3_4b_full_width_parameter_count():
    n = count_params(param_shapes(get_config("qwen3-4b")))
    assert n == 4_412_079_616  # 17.6 GB in float32, 8.8 GB in bf16


def test_params_from_jax_refuses_a_misshapen_tree(runs):
    cfg, j, _ = runs("qwen3-4b")
    bad = {"top": dict(j["params"]["top"]), "groups": j["params"]["groups"]}
    bad["top"]["embed"] = bad["top"]["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(cfg, bad, device="cpu")
    bad["top"] = {k: v for k, v in j["params"]["top"].items() if k != "head"}
    with pytest.raises(ValueError, match="names"):
        params_from_jax(cfg, bad, device="cpu")


def test_an_unknown_family_is_refused():
    cfg = dataclasses.replace(get_reduced("qwen3-4b"), family="mamba")
    with pytest.raises(ValueError, match="unknown model family 'mamba'"):
        get_model(cfg, device="cpu")


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(get_reduced("qwen3-4b"))


def test_params_from_jax_defaults_to_the_card(runs):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    cfg, j, _ = runs("qwen3-4b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(cfg, j["params"])


def test_the_model_refuses_tensors_on_another_device(runs):
    """A model never computes where its device is not: params, batch, cache
    or token elsewhere (here the meta device stands for the card) raise."""
    cfg, j, port = runs("qwen3-4b")
    model, params = port["model"], port["params"]
    assert model.device == torch.device("cpu")
    batch = _port_batch(j["batch"])
    elsewhere = {"top": {k: t.to("meta") if k == "embed" else t
                         for k, t in params["top"].items()},
                 "groups": params["groups"]}
    with pytest.raises(ValueError, match="params holds a tensor on meta"):
        model.prefill(elsewhere, batch)
    with pytest.raises(ValueError, match="batch holds a tensor on meta"):
        model.prefill(params, {k: v.to("meta") for k, v in batch.items()})
    _, cache = model.prefill(params, batch, max_seq=S + GROW)
    tok = torch.tensor(j["tok"], dtype=torch.long)
    with pytest.raises(ValueError, match="token holds a tensor on meta"):
        model.decode_step(params, cache, tok.to("meta"))
    cache["layers"][0]["k"] = cache["layers"][0]["k"].to("meta")
    with pytest.raises(ValueError, match="cache holds a tensor on meta"):
        model.decode_step(params, cache, tok)


# ------------------------------------------------------------------ serve CLI
@pytest.mark.parametrize("name", ["qwen3-4b", "olmoe-1b-7b", "llava-next-34b", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "whisper-small"])
def test_serve_lm_on_the_cpu(name, capsys):
    out = serve.main(["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--decode-steps", "4"])
    text = capsys.readouterr().out
    assert "ms/step (median after the first)" in text and "tok/s on cpu" in text
    assert out["tokens"].shape == (2, 5) and len(out["decode_ms"]) == 4
    assert out["tok_per_s"] > 0 and np.isfinite(out["first_logits"]).all()
    cfg = get_reduced(name)
    assert out["tokens"].max() < cfg.vocab
    if cfg.family == "moe":
        assert 0.0 <= out["moe_drop"]["prefill"] < 1.0 and "dropped routed slots" in text
    # the first decode step equals the model's own decode on the same prompt
    model = get_model(cfg, device="cpu")
    params = model.init(serve.LM_SEED)
    side, n_side, n_text = serve.lm_layout(cfg, 16)
    assert out["prompt"].shape == (2, n_text) and set(out["side"]) == {side} - {None}
    for v in out["side"].values():  # the JAX CLI's inputs: ones
        assert v.shape == (2, n_side, cfg.d_model) and v.dtype == torch.bfloat16
        assert bool((v == 1).all())
    batch = {"tokens": torch.from_numpy(out["prompt"]), **out["side"]}
    logits, cache = model.prefill(params, batch, max_seq=20)
    dec, _ = model.decode_step(params, cache, torch.argmax(logits[:, : cfg.vocab], -1))
    np.testing.assert_array_equal(dec.numpy(), out["first_logits"])
