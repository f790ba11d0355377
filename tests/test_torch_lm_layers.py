"""The port's LM building blocks against the JAX package's, on the CPU.

The same inputs, drawn with numpy, go through ``repro.models.layers`` and
``repro_torch.models.layers``.  Contract: in float32, within 1e-5 (rtol
and atol); int8 cache values and MoE routes, ranks and kept slots equal.
JAX's ``flash_decode`` runs on the (1, 1) mesh, where its ``shard_map``
sums over one shard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as J

from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, jax_out, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jax_out, np.float32), **(tol or TOL))


# ------------------------------------------------------------ norms, rope
def test_rmsnorm():
    rng = _rng(0)
    x, s = _f32(rng, 2, 5, 48, scale=3.0), _f32(rng, 48)
    _close(L.rmsnorm(_t(x), _t(s), 1e-6), J.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6))


def test_layernorm_uses_the_population_variance():
    rng = _rng(1)
    x, s, b = _f32(rng, 2, 5, 48, scale=2.0) + 0.5, _f32(rng, 48), _f32(rng, 48)
    got = L.layernorm(_t(x), _t(s), _t(b), 1e-5)
    _close(got, J.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5))
    unbiased = (_t(x) - _t(x).mean(-1, keepdim=True)) / torch.sqrt(
        _t(x).var(-1, keepdim=True) + 1e-5) * _t(s) + _t(b)
    assert not torch.allclose(got, unbiased, **TOL)


@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_rope_half_split(positions):
    rng = _rng(2)
    x = _f32(rng, 2, 7, 6, 32)
    pos = np.arange(7) if positions == "prefill" else np.array([41])
    if positions == "decode":
        x = x[:, :1]
    _close(L.rope(_t(x), _t(pos), 1e6), J.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


# ------------------------------------------------------------- attention
def _heads(name):
    cfg = jax_get_config(name)
    return cfg.padded_heads, np.asarray(cfg.head_mask()).reshape(-1)


@pytest.mark.parametrize("case", [
    dict(S=20, q_chunk=8, window=0),     # ragged q_chunk tail
    dict(S=16, q_chunk=16, window=0),    # one chunk
    dict(S=20, q_chunk=8, window=5),     # sliding window
])
def test_attention_full_gqa_with_padded_heads(case):
    """GQA with llama3.2-3b's padding: 24 q heads over 8 kv heads pad to
    (KVp, Gp) = (8, 4); the padded heads come out zero."""
    (kvp, gp), hm = _heads("llama3.2-3b")
    assert (kvp, gp) == (8, 4)
    rng = _rng(3)
    S, dh = case["S"], 16
    q, k, v = _f32(rng, 2, S, kvp * gp, dh), _f32(rng, 2, S, kvp, dh), _f32(rng, 2, S, kvp, dh)
    kw = dict(group_size=gp, causal=True, window=case["window"], q_chunk=case["q_chunk"])
    got = L.attention_full(_t(q), _t(k), _t(v), _t(hm), **kw)
    want = J.attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(hm), **kw)
    _close(got, want)
    assert got.shape == (2, S, kvp * gp, dh)
    assert torch.all(got.reshape(2, S, kvp, gp, dh)[:, :, :, 3] == 0)


def test_attention_maps_q_heads_to_kv_heads_by_repeat_interleave():
    """Head h reads kv head h // G: a ``Tensor.repeat`` tiling would not."""
    rng = _rng(4)
    q, k, v = _f32(rng, 1, 6, 4, 8), _f32(rng, 1, 6, 2, 8), _f32(rng, 1, 6, 2, 8)
    got = L.attention_full(_t(q), _t(k), _t(v), torch.ones(4), group_size=2, q_chunk=6)
    alone = L.attention_full(_t(q[:, :, :2]), _t(k[:, :, :1]), _t(v[:, :, :1]),
                             torch.ones(2), group_size=2, q_chunk=6)
    torch.testing.assert_close(got[:, :, :2], alone, **TOL)


def test_quantize_kv_int8_values_equal():
    rng = _rng(5)
    x = _f32(rng, 2, 9, 4, 16, scale=2.0)
    x[0, 0, 0] = 0.0                       # an all-zero slice: the 1e-8 floor
    x[1, 2, 3, :4] = [0.5, -0.5, 1.5, 127.0]
    q, s = L.quantize_kv(_t(x))
    jq, js = J.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_flash_decode_one_card(cache, mesh11):
    """One decode step: the new token written at ``pos``, keys <= pos read.
    ("bf16" names the unquantized path; the inputs here are float32.)"""
    (kvp, gp), hm = _heads("qwen3-4b")
    rng = _rng(6)
    B, Smax, dh, pos = 2, 24, 16, 17
    q = _f32(rng, B, kvp * gp, dh)
    kc, vc = _f32(rng, B, Smax, kvp, dh), _f32(rng, B, Smax, kvp, dh)
    kc[:, pos + 1:] = vc[:, pos + 1:] = 0.0
    kn, vn = _f32(rng, B, kvp, dh), _f32(rng, B, kvp, dh)
    j = dict(k_cache=jnp.asarray(kc), v_cache=jnp.asarray(vc))
    p = dict(k_cache=_t(kc), v_cache=_t(vc))
    if cache == "int8":
        kq, ks = J.quantize_kv(jnp.asarray(kc))
        vq, vs = J.quantize_kv(jnp.asarray(vc))
        j = dict(k_cache=kq, v_cache=vq, k_scale=ks, v_scale=vs)
        p = {k: _t(np.asarray(v)) for k, v in j.items()}
    want = J.flash_decode(mesh11, ("data",), jnp.asarray(q), k_new=jnp.asarray(kn),
                          v_new=jnp.asarray(vn), pos=jnp.asarray(pos, jnp.int32),
                          head_mask=jnp.asarray(hm), group_size=gp, **j)
    got = L.flash_decode(_t(q), k_new=_t(kn), v_new=_t(vn), pos=pos, head_mask=_t(hm),
                         group_size=gp, **p)
    _close(got, want[0])
    # the caches (and scales) were written in place as JAX returns them
    for name, w in zip(["k_cache", "v_cache", "k_scale", "v_scale"], want[1:]):
        np.testing.assert_array_equal(p[name].numpy(), np.asarray(w))


# ------------------------------------------------------------------ MLPs
def test_swiglu():
    rng = _rng(7)
    x, wi, wg, wo = _f32(rng, 2, 5, 32), _f32(rng, 32, 48), _f32(rng, 32, 48), _f32(rng, 48, 32)
    _close(L.swiglu(*map(_t, (x, wi, wg, wo))), J.swiglu(*map(jnp.asarray, (x, wi, wg, wo))))


def test_gelu_mlp_is_the_tanh_approximation():
    rng = _rng(8)
    args = (_f32(rng, 2, 5, 32, scale=2.0), _f32(rng, 32, 48), _f32(rng, 48),
            _f32(rng, 48, 32), _f32(rng, 32))
    _close(L.gelu_mlp(*map(_t, args)), J.gelu_mlp(*map(jnp.asarray, args)))


# ------------------------------------------------------------------- MoE
def _keep_ref(top_e: np.ndarray, cap: int) -> np.ndarray:
    """Independent reference: in flat (token, slot) order, the first ``cap``
    slots routed to each expert are kept."""
    seen, keep = {}, []
    for e in top_e.reshape(-1):
        seen[e] = seen.get(e, 0) + 1
        keep.append(seen[e] <= cap)
    return np.array(keep)


@pytest.mark.parametrize("case", [
    dict(B=3, S=8, E=8, k=2, cf=1.0, zero_router=False),    # prefill, drops
    dict(B=4, S=1, E=8, k=2, cf=1.25, zero_router=False),   # decode: cap 1
    dict(B=2, S=4, E=4, k=2, cf=1.25, zero_router=True),    # all ties
    dict(B=2, S=6, E=8, k=1, cf=1.25, zero_router=False),   # top-1 (maverick)
])
def test_moe_dispatch_matches_jax(case):
    rng = _rng(9)
    B, S, E, k, D, F = case["B"], case["S"], case["E"], case["k"], 16, 24
    x = _f32(rng, B, S, D)
    router = np.zeros((D, E), np.float32) if case["zero_router"] else _f32(rng, D, E)
    w_in, w_gate, w_out = _f32(rng, E, D, F, scale=0.3), _f32(rng, E, D, F, scale=0.3), \
        _f32(rng, E, F, D, scale=0.3)
    kw = dict(top_k=k, capacity_factor=case["cf"])
    want = J._moe_local(*map(jnp.asarray, (x, router, w_in, w_gate, w_out)),
                        n_experts=E, **kw)
    stats = {}
    got = L.moe_block(*map(_t, (x, router, w_in, w_gate, w_out)), stats=stats, **kw)
    _close(got, want)
    _close(got, J.moe_block(*map(jnp.asarray, (x, router, w_in, w_gate, w_out)), **kw))

    top_e, top_p, keep, rank, cap = L.moe_route(_t(x), _t(router), n_experts=E, **kw)
    assert cap == int(max(1, case["cf"] * k * B * S / E))
    logits = jnp.einsum("nd,de->ne", jnp.asarray(x).reshape(-1, D), jnp.asarray(router))
    jp, je = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), axis=-1), k)
    assert np.array_equal(top_e.numpy(), np.asarray(je))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jp / jp.sum(-1, keepdims=True)), **TOL)
    assert np.array_equal(keep.numpy(), _keep_ref(np.asarray(je), cap))
    assert int(stats["kept"]) == int(keep.sum()) and stats["slots"] == B * S * k
    if case["S"] > 1 and case["cf"] == 1.0:
        assert not bool(keep.all())  # the case drops slots
    if case["zero_router"]:  # ties go to the lower index, as lax.top_k's
        assert np.array_equal(top_e.numpy(), np.tile(np.arange(k), (B * S, 1)))
