"""Whisper-style encoder-decoder of the port (``repro.models.whisper``), for
serving and training.

The conv/mel frontend is a stub, as in the JAX package: the caller passes
precomputed frame embeddings ``batch["frames"]`` (B, S_enc, D).  Pre-LN
LayerNorm blocks, GELU MLPs with biases, sinusoidal absolute positions, a
bidirectional encoder closed by ``ln_enc``, a decoder with causal
self-attention and cross-attention over the encoder states, logits tied to
``embed``.  Attention projections carry biases on q, v and the output, none
on k.

Two sinusoid roundings, each where JAX uses it: prefill and the encoder
add ``_sinusoid``, computed in float64 then rounded to float32; decode adds
``_sin_at``, computed in float32.  They differ in the last bits.

Parameters: ``{"top", "enc": {name: (n_enc, ...)}, "dec": {name: (L, ...)}}``,
all bf16 (float32 masters for training, ``masters=True``, cast at their
use).  ``train_loss`` encodes the frames and runs the decoder over the
whole sequence, each layer rematerialised as in JAX.  The cache:
self-attention ``k``/``v`` (L, B, max_seq, KVp, dh) bf16, written in place
by decode, and the cross-attention ``xk``/``xv`` (L, B, S_enc, KVp, dh)
bf16 computed at prefill and only read after.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models import layers as Lyr
from repro_torch.models.base import (
    ModelConfig,
    ParamFactory,
    full_spec,
    layer_slices,
    make_remat,
    zeros_of,
)
from repro_torch.models.transformer import _ce_loss, _embed_tokens, _masks

F32_ENTRIES = frozenset()  # every entry is cast to the activations' dtype at its use


@functools.lru_cache(maxsize=8)
def _sinusoid(S: int, D: int) -> torch.Tensor:
    """(S, D) float32 positions, computed in float64 as JAX does (numpy)."""
    pos = np.arange(S)[:, None]
    dim = np.arange(D // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / D))
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
                            .astype(np.float32))


def _sin_at(pos: int, D: int, device) -> torch.Tensor:
    """(D,) float32 position ``pos``, computed in float32 (JAX's decode)."""
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(pos), dtype=torch.float32, device=device) / (10000 ** (2 * dim / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)])


def _attn_entries(cfg: ModelConfig, prefix: str = "") -> dict:
    D, dh = cfg.d_model, cfg.head_dim
    KVp, Gp = cfg.padded_heads
    Hp = KVp * Gp
    return {prefix + "wq": ((D, Hp * dh), "dense", ("data", "model")),
            prefix + "bq": ((Hp * dh,), "zeros", ("model",)),
            prefix + "wk": ((D, KVp * dh), "dense", ("data", None)),
            prefix + "wv": ((D, KVp * dh), "dense", ("data", None)),
            prefix + "bv": ((KVp * dh,), "zeros", None),
            prefix + "wo": ((Hp * dh, D), "dense", ("model", "data")),
            prefix + "bo": ((D,), "zeros", None)}


def _mlp_entries(cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {"wi": ((D, F_), "dense", ("data", "model")), "bi": ((F_,), "zeros", ("model",)),
            "wod": ((F_, D), "dense", ("model", "data")), "bo2": ((D,), "zeros", None)}


def _ln(names, D):
    e = {}
    for n in names:
        e[n] = ((D,), "ones", None)
        e[n + "_b"] = ((D,), "zeros", None)
    return e


def _enc_layer(cfg: ModelConfig) -> dict:
    return {**_ln(("ln1", "ln2"), cfg.d_model), **_attn_entries(cfg), **_mlp_entries(cfg)}


def _dec_layer(cfg: ModelConfig) -> dict:
    return {**_ln(("ln1", "lnx", "ln2"), cfg.d_model), **_attn_entries(cfg),
            **_attn_entries(cfg, "x_"), **_mlp_entries(cfg)}


def _top_entries(cfg: ModelConfig) -> dict:
    return {"embed": ((cfg.padded_vocab, cfg.d_model), "dense", ("model", "data")),
            **_ln(("ln_enc", "ln_dec"), cfg.d_model)}


def _n_enc(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


def _trees(cfg: ModelConfig):
    return (("top", _top_entries(cfg), None), ("enc", _enc_layer(cfg), _n_enc(cfg)),
            ("dec", _dec_layer(cfg), cfg.n_layers))


def param_shapes(cfg: ModelConfig) -> dict:
    """JAX's ``abstract_init`` tree, no allocation."""
    return {t: {k: ((n,) if n else ()) + s for k, (s, _, _) in e.items()}
            for t, e, n in _trees(cfg)}


def param_specs(cfg: ModelConfig) -> dict:
    """JAX's ``param_specs`` tree, one entry a dimension (``full_spec``)."""
    return {t: {k: full_spec(sp, len(s), stacked=bool(n)) for k, (s, _, sp) in e.items()}
            for t, e, n in _trees(cfg)}


def init(cfg: ModelConfig, seed: int = 0, device="cuda", masters: bool = False) -> dict:
    """Seeded random weights on ``device``, in bf16 (float32 with ``masters``)."""
    pf = ParamFactory(seed, device, masters=masters)
    return {t: {k: pf.make(k, ((n,) if n else ()) + s, kind) for k, (s, kind, _) in e.items()}
            for t, e, n in _trees(cfg)}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int, enc_seq: int = 0) -> dict:
    """The cache's tensors as (shape, dtype, sharding), JAX's
    ``abstract_cache(cfg, batch, max_seq, enc_seq)`` template (``"data"``
    for the batch axis): bf16 self-attention k/v of ``max_seq`` slots,
    cross k/v of ``enc_seq``."""
    KVp, _ = cfg.padded_heads
    L, dh = cfg.n_layers, cfg.head_dim
    spec = (None, "data", "model", None, None)
    kv = lambda n: ((L, batch, n, KVp, dh), torch.bfloat16, spec)  # noqa: E731
    return {"k": kv(max_seq), "v": kv(max_seq), "xk": kv(enc_seq), "xv": kv(enc_seq)}


def alloc_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
                enc_seq: int = 0) -> dict:
    """Zeroed cache of :func:`cache_specs`'s tensors."""
    return {**zeros_of(cache_specs(cfg, batch, max_seq, enc_seq), device), "length": 0}


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


def _proj_qkv(cfg, lp, hq, hkv, prefix=""):
    KVp, Gp = cfg.padded_heads
    dh = cfg.head_dim
    B, Sq, _ = hq.shape
    Skv = hkv.shape[1]
    bf = hq.dtype
    q = hq @ lp[prefix + "wq"].to(bf) + lp[prefix + "bq"].to(bf)
    k = hkv @ lp[prefix + "wk"].to(bf)
    v = hkv @ lp[prefix + "wv"].to(bf) + lp[prefix + "bv"].to(bf)
    return (q.reshape(B, Sq, KVp * Gp, dh), k.reshape(B, Skv, KVp, dh),
            v.reshape(B, Skv, KVp, dh))


def _attn_full(cfg, lp, hq, hkv, head_mask, causal, prefix=""):
    B, Sq, _ = hq.shape
    q, k, v = _proj_qkv(cfg, lp, hq, hkv, prefix)
    o = Lyr.attention_full(q, k, v, head_mask, group_size=cfg.padded_heads[1],
                           causal=causal, q_chunk=cfg.q_chunk)
    bf = hq.dtype
    return o.reshape(B, Sq, -1) @ lp[prefix + "wo"].to(bf) + lp[prefix + "bo"].to(bf), k, v


def _ln_of(cfg, x, p, name):
    return Lyr.layernorm(x, p[name], p[name + "_b"], cfg.norm_eps)


def _mlp(lp, h):
    return Lyr.gelu_mlp(h, lp["wi"], lp["bi"], lp["wod"], lp["bo2"])


def _layer(params, tree: str, i: int) -> dict:
    return {k: t[i] for k, t in params[tree].items()}


def _enc_block(cfg, lp, x, head_mask):
    h = _ln_of(cfg, x, lp, "ln1")
    x = x + _attn_full(cfg, lp, h, h, head_mask, causal=False)[0]
    return x + _mlp(lp, _ln_of(cfg, x, lp, "ln2"))


def _dec_block(cfg, lp, x, enc, head_mask):
    """One decoder layer over the full sequence -> (x, k, v, xk, xv)."""
    h = _ln_of(cfg, x, lp, "ln1")
    o, k, v = _attn_full(cfg, lp, h, h, head_mask, causal=True)
    x = x + o
    ox, xk, xv = _attn_full(cfg, lp, _ln_of(cfg, x, lp, "lnx"), enc, head_mask,
                            causal=False, prefix="x_")
    x = x + ox
    return x + _mlp(lp, _ln_of(cfg, x, lp, "ln2")), k, v, xk, xv


def _encode(cfg, params, frames, head_mask, train: bool = False):
    """frames (B, S_enc, D) -> encoder states (B, S_enc, D) bf16; with
    ``train``, each layer rematerialised (JAX's scan body)."""
    x = frames.to(torch.bfloat16)
    x = x + _sinusoid(x.shape[1], cfg.d_model).to(x.device, x.dtype)[None]
    block = make_remat(cfg, _enc_block) if train else _enc_block
    for lp in layer_slices(params["enc"], _n_enc(cfg)):
        x = block(cfg, lp, x, head_mask)
    return _ln_of(cfg, x, params["top"], "ln_enc")


def _embed_dec(cfg, top, tokens):
    """The decoder's input: token rows plus ``_sinusoid`` positions."""
    x = _embed_tokens(top, tokens)
    return x + _sinusoid(tokens.shape[1], cfg.d_model).to(x.device, x.dtype)[None]


def _logits(top, x, vocab_mask):
    """Tied to ``embed``: (..., D) bf16 -> (..., Vp) float32 + vocab mask."""
    return (x @ top["embed"].to(x.dtype).T).float() + vocab_mask


# --------------------------------------------------------------------------
# public model functions
# --------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, batch: dict, max_seq: int | None = None,
            stats: dict | None = None):
    """``batch["frames"]`` (B, S_enc, D) and ``batch["tokens"]`` (B, S) ->
    (last-token logits (B, Vp) float32 with the vocab mask, a cache whose
    self-attention holds ``max_seq`` slots (default S) filled to S and whose
    cross-attention holds the encoder's S_enc).  ``stats`` is unused."""
    tokens = batch["tokens"]
    top = params["top"]
    dev = tokens.device
    B, S = tokens.shape
    head_mask, vocab_mask = _masks(cfg, dev)
    enc = _encode(cfg, params, batch["frames"], head_mask)
    cache = alloc_cache(cfg, B, max_seq or S, dev, enc_seq=enc.shape[1])
    x = _embed_dec(cfg, top, tokens)
    for i in range(cfg.n_layers):
        x, k, v, xk, xv = _dec_block(cfg, _layer(params, "dec", i), x, enc, head_mask)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        cache["xk"][i] = xk
        cache["xv"][i] = xv
    x = _ln_of(cfg, x[:, -1:], top, "ln_dec")
    cache["length"] = S
    return _logits(top, x, vocab_mask)[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache: dict, token, stats: dict | None = None):
    """One step: token (B,) at position ``pos = cache["length"]`` -> (logits
    (B, Vp) float32, the cache with k/v written in place at ``pos``; the
    cross-attention's xk/xv are only read)."""
    pos = cache["length"]
    top = params["top"]
    dev = token.device
    Gp, dh = cfg.padded_heads[1], cfg.head_dim
    head_mask, vocab_mask = _masks(cfg, dev)
    x = _embed_tokens(top, token)                # (B, D)
    x = x + _sin_at(pos, cfg.d_model, dev).to(x.dtype)
    B = x.shape[0]
    enc_last = cache["xk"].shape[2] - 1
    for i in range(cfg.n_layers):
        lp = _layer(params, "dec", i)
        h = _ln_of(cfg, x[:, None], lp, "ln1")
        q, k, v = _proj_qkv(cfg, lp, h, h)
        o = Lyr.flash_decode(q[:, 0], cache["k"][i], cache["v"][i], k[:, 0], v[:, 0], pos,
                             head_mask, Gp)
        bf = x.dtype
        x = x + o.reshape(B, -1) @ lp["wo"].to(bf) + lp["bo"].to(bf)
        # cross-attention over the encoder's k/v, read only
        hx = _ln_of(cfg, x[:, None], lp, "lnx")
        qx = (hx @ lp["x_wq"].to(bf) + lp["x_bq"].to(bf)).reshape(B, -1, dh)
        ox = Lyr.flash_decode(qx, cache["xk"][i], cache["xv"][i], None, None, enc_last,
                              head_mask, Gp, write=False)
        x = x + ox.reshape(B, -1) @ lp["x_wo"].to(bf) + lp["x_bo"].to(bf)
        x = x + _mlp(lp, _ln_of(cfg, x[:, None], lp, "ln2"))[:, 0]
    x = _ln_of(cfg, x[:, None], top, "ln_dec")
    cache["length"] = pos + 1
    return _logits(top, x, vocab_mask)[:, 0], cache


def train_loss(cfg: ModelConfig, params, batch: dict):
    """The mean next-token cross entropy of the decoder (JAX's
    ``train_loss``): ``batch["frames"]`` (B, S_enc, D) encoded, then
    ``batch["tokens"]`` and ``batch["labels"]`` (B, S) through the decoder
    over the whole sequence, each layer of both stacks rematerialised."""
    top = params["top"]
    dev = batch["tokens"].device
    head_mask, vocab_mask = _masks(cfg, dev)
    enc = _encode(cfg, params, batch["frames"], head_mask, train=True)
    x = _embed_dec(cfg, top, batch["tokens"])
    block = make_remat(cfg, lambda lp, x: _dec_block(cfg, lp, x, enc, head_mask)[0])
    for lp in layer_slices(params["dec"], cfg.n_layers):
        x = block(lp, x)
    x = _ln_of(cfg, x, top, "ln_dec")
    return _ce_loss(_logits(top, x, vocab_mask), batch["labels"])
