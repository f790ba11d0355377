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

**On a device mesh** (``mesh=``, a ``launch.mesh.RankMesh``), every rank
calls ``init``/``params_from_jax``, ``alloc_cache``, ``prefill``,
``decode_step`` and ``train_loss`` with the same arguments and holds its
shards by ``param_specs`` and ``cache_specs`` (JAX's ``abstract_init`` and
``abstract_cache``); a weight's ``"data"`` blocks are gathered at its use
(``base.wcast``).  The residual streams are whole on every ``"model"``
rank and the batch split over ``dp`` (``base.batch_axes``):

* every attention (the encoder's, the decoder's self- and
  cross-attention) runs on the rank's q heads: ``wq`` and ``bq``
  column-parallel, ``wk``, ``wv`` and ``bv`` whole (each rank computes the
  whole K/V head), ``wo`` row-parallel (``layers.row_parallel``, a float32
  sum over ``"model"``) with ``bo`` added once, after the sum; the MLPs
  are ``layers.gelu_mlp`` on the rank's block of d_ff, ``bo2`` after the
  sum;
* the cache is sequence-sharded over ``"model"``, as JAX's ``prefill``
  pins it: the rank holds slots ``ax · s_loc ... (ax+1) · s_loc - 1`` of
  the self-attention's ``max_seq`` and of the encoder's length, and
  ``prefill`` writes the prompt's and the encoder's K/V there;
* ``decode_step`` gathers q's heads over ``"model"`` and runs the
  sequence-sharded ``layers.flash_decode`` twice: self-attention writing
  at ``pos`` on the rank that owns it, cross-attention read only
  (``write=False``) over every encoder slot;
* ``train_loss`` (FSDP over the data axes, tensor parallel over
  ``"model"``, as JAX's jitted step) keeps the transformer's contract, the
  frames split with the batch and the cross entropy vocabulary-parallel;
  each attention's q input, k and v (self and cross: the encoder's output
  feeds every decoder layer's cross k and v) and each MLP's input feed
  the rank's heads or d_ff block, so their gradients are summed over
  ``"model"`` (``base._model_grad_sum``).

A batch that the data axes ``dp`` do not divide, or a self- or
cross-attention length that the ``"model"`` axis does not divide, raises
``ValueError`` naming both numbers.  Without a mesh, and on one rank on
each axis, every function computes what it computed before meshes
existed, to the bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models import layers as Lyr
from repro_torch.models.base import (
    MESH_DP,
    ModelConfig,
    ParamFactory,
    _block,
    _embed_tokens,
    _gathered,
    _model_gather,
    _model_grad_sum,
    _rows,
    _split,
    _train_rows,
    full_spec,
    layer_slices,
    make_remat,
    rank_specs,
    vocab_logits,
    zeros_of,
)
from repro_torch.models.transformer import _ce_loss, _masks

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


def init(cfg: ModelConfig, seed: int = 0, device="cuda", masters: bool = False,
         mesh=None) -> dict:
    """Seeded random weights on ``device``, in bf16 (float32 with
    ``masters``).  On a ``mesh``, this rank's shards (``base.shard``) of the
    same weights: each entry is drawn whole, in the same order, and cut at
    once."""
    pf = ParamFactory(seed, device, masters=masters)
    return {t: {k: pf.draw(k, ((n,) if n else ()) + s, kind, sp, mesh, stacked=bool(n))
                for k, (s, kind, sp) in e.items()}
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
                enc_seq: int = 0, mesh=None, dp=MESH_DP) -> dict:
    """Zeroed cache of :func:`cache_specs`'s tensors.  On a ``mesh``, this
    rank's shards of the cache of the global ``batch`` (the batch over the
    axes ``dp``, both sequences over ``"model"``)."""
    specs = cache_specs(cfg, batch, max_seq, enc_seq)
    if mesh is not None:
        _split(mesh, batch, dp=dp)
        n_model = mesh.axis_size("model")
        for what, n in (("self-attention cache's", max_seq),
                        ("cross-attention cache's (the encoder's length)", enc_seq)):
            if n % n_model:
                raise ValueError(f"the {what} {n} slots do not divide over the {n_model} "
                                 "ranks of the model axis")
        specs = rank_specs(specs, mesh, dp)
    return {**zeros_of(specs, device), "length": 0}


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


def _proj_qkv(cfg, lp, hq, hkv, prefix="", mesh=None):
    """q (B, Sq, heads, dh) of ``hq``, k and v (B, Skv, KVp, dh) of ``hkv``.
    On a mesh q is this rank's block of the heads, k and v whole: q's input
    and k and v feed the rank's heads, so their gradients are summed over
    ``"model"``."""
    KVp, Gp = cfg.padded_heads
    dh = cfg.head_dim
    B, Sq, _ = hq.shape
    Skv = hkv.shape[1]
    bf = hq.dtype
    q = _model_grad_sum(hq, mesh) @ lp[prefix + "wq"].to(bf) + lp[prefix + "bq"].to(bf)
    k = _model_grad_sum(hkv @ lp[prefix + "wk"].to(bf), mesh)
    v = _model_grad_sum(hkv @ lp[prefix + "wv"].to(bf) + lp[prefix + "bv"].to(bf), mesh)
    # q: KVp * Gp heads, or this rank's block of them
    return (q.reshape(B, Sq, -1, dh), k.reshape(B, Skv, KVp, dh),
            v.reshape(B, Skv, KVp, dh))


def _attn_full(cfg, lp, hq, hkv, head_mask, causal, prefix="", mesh=None):
    """Attention of hq over hkv -> (out, k, v); on a mesh over the rank's q
    heads (k and v whole), the output summed over ``"model"`` before
    ``bo``."""
    B, Sq, _ = hq.shape
    heads = _block(mesh, cfg.n_heads_padded)
    q, k, v = _proj_qkv(cfg, lp, hq, hkv, prefix, mesh)
    o = Lyr.attention_full(q, k, v, head_mask[heads], group_size=cfg.padded_heads[1],
                           causal=causal, q_chunk=cfg.q_chunk, heads=heads)
    bf = hq.dtype
    out = Lyr.row_parallel(o.reshape(B, Sq, -1), lp[prefix + "wo"], mesh)
    return out + lp[prefix + "bo"].to(bf), k, v


def _ln_of(cfg, x, p, name):
    return Lyr.layernorm(x, p[name], p[name + "_b"], cfg.norm_eps)


def _mlp(lp, h, mesh=None):
    return Lyr.gelu_mlp(h, lp["wi"], lp["bi"], lp["wod"], lp["bo2"], mesh)


def _layer(cfg, params, tree: str, i: int, mesh=None, skip=()) -> dict:
    """Layer ``i`` of the ``"enc"`` or ``"dec"`` stack but the entries in
    ``skip``; on a mesh with each weight's ``"data"`` blocks gathered."""
    entries = _enc_layer(cfg) if tree == "enc" else _dec_layer(cfg)
    return _gathered(entries, {k: t[i] for k, t in params[tree].items() if k not in skip},
                     mesh)


def _enc_block(cfg, lp, x, head_mask, mesh=None):
    h = _ln_of(cfg, x, lp, "ln1")
    x = x + _attn_full(cfg, lp, h, h, head_mask, causal=False, mesh=mesh)[0]
    return x + _mlp(lp, _ln_of(cfg, x, lp, "ln2"), mesh)


def _dec_block(cfg, lp, x, enc, head_mask, mesh=None):
    """One decoder layer over the full sequence -> (x, k, v, xk, xv)."""
    h = _ln_of(cfg, x, lp, "ln1")
    o, k, v = _attn_full(cfg, lp, h, h, head_mask, causal=True, mesh=mesh)
    x = x + o
    ox, xk, xv = _attn_full(cfg, lp, _ln_of(cfg, x, lp, "lnx"), enc, head_mask,
                            causal=False, prefix="x_", mesh=mesh)
    x = x + ox
    return x + _mlp(lp, _ln_of(cfg, x, lp, "ln2"), mesh), k, v, xk, xv


def _encode(cfg, params, top, frames, head_mask, train: bool = False, mesh=None):
    """frames (B, S_enc, D) -> encoder states (B, S_enc, D) bf16; with
    ``train``, each layer rematerialised (JAX's scan body), its ``"data"``
    blocks gathered inside the body on a mesh.  ``top``: the top's weights
    (``ln_enc``)."""
    x = frames.to(torch.bfloat16)
    x = x + _sinusoid(x.shape[1], cfg.d_model).to(x.device, x.dtype)[None]
    if train:
        entries = _enc_layer(cfg)
        block = make_remat(cfg, lambda lp, x: _enc_block(cfg, _gathered(entries, lp, mesh), x,
                                                         head_mask, mesh))
        for lp in layer_slices(params["enc"], _n_enc(cfg)):
            x = block(lp, x)
    else:
        for i in range(_n_enc(cfg)):
            x = _enc_block(cfg, _layer(cfg, params, "enc", i, mesh), x, head_mask, mesh)
    return _ln_of(cfg, x, top, "ln_enc")


def _embed_dec(cfg, top, tokens, mesh=None):
    """The decoder's input: token rows plus ``_sinusoid`` positions."""
    x = _embed_tokens(top, tokens, mesh)
    return x + _sinusoid(tokens.shape[1], cfg.d_model).to(x.device, x.dtype)[None]


def _logits(top, x, vocab_mask, mesh=None, gather: bool = True):
    """Tied to ``embed``: (..., D) bf16 -> (..., Vp) float32 + vocab mask;
    on a mesh vocabulary-parallel (``base.vocab_logits``)."""
    return vocab_logits(top["embed"].T, x, vocab_mask, mesh, gather)


def _write_slots(dst, src, mesh=None):
    """A (B, T, KVp, dh) sequence's k or v into the cache's slots ``dst``
    (B, s_loc, KVp, dh); on a mesh only the slots this rank holds, ``ax ·
    s_loc ...`` on ``"model"``."""
    s_loc = dst.shape[1]
    lo = 0 if mesh is None else mesh.axis_index("model") * s_loc
    hi = min(src.shape[1], lo + s_loc)
    if hi > lo:
        dst[:, :hi - lo] = src[:, lo:hi]


# --------------------------------------------------------------------------
# public model functions
# --------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, batch: dict, max_seq: int | None = None,
            stats: dict | None = None, mesh=None, dp=MESH_DP):
    """``batch["frames"]`` (B, S_enc, D) and ``batch["tokens"]`` (B, S) ->
    (last-token logits (B, Vp) float32 with the vocab mask, a cache whose
    self-attention holds ``max_seq`` slots (default S) filled to S and whose
    cross-attention holds the encoder's S_enc).  ``stats`` is unused.  On a
    ``mesh`` (module docstring): this rank's shards of the weights, the
    global batch in, the data shard's logits and cache shard out."""
    dev = batch["tokens"].device
    B, S = batch["tokens"].shape
    max_seq = max_seq or S
    if max_seq < S:
        raise ValueError(f"a cache of {max_seq} slots cannot hold the {S}-token prompt")
    cache = alloc_cache(cfg, B, max_seq, dev, enc_seq=batch["frames"].shape[1], mesh=mesh,
                        dp=dp)
    batch = {k: _rows(mesh, t, dp) for k, t in batch.items()}
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    head_mask, vocab_mask = _masks(cfg, dev)
    enc = _encode(cfg, params, top, batch["frames"], head_mask, mesh=mesh)
    x = _embed_dec(cfg, top, batch["tokens"], mesh)
    for i in range(cfg.n_layers):
        x, k, v, xk, xv = _dec_block(cfg, _layer(cfg, params, "dec", i, mesh), x, enc,
                                     head_mask, mesh)
        for name, t in (("k", k), ("v", v), ("xk", xk), ("xv", xv)):
            _write_slots(cache[name][i], t, mesh)
    x = _ln_of(cfg, x[:, -1:], top, "ln_dec")
    cache["length"] = S
    return _logits(top, x, vocab_mask, mesh)[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache: dict, token, stats: dict | None = None,
                mesh=None, dp=MESH_DP):
    """One step: token (B,) at position ``pos = cache["length"]`` -> (logits
    (B, Vp) float32, the cache with k/v written in place at ``pos``; the
    cross-attention's xk/xv are only read).  On a ``mesh``: the global
    batch's tokens in, the data shard's logits out."""
    pos = cache["length"]
    dev = token.device
    token = _rows(mesh, token, dp)
    B = token.shape[0]
    if cache["k"].shape[1] != B:
        raise ValueError(f"the cache holds {cache['k'].shape[1]} rows, the token's shard {B}")
    Gp, dh = cfg.padded_heads[1], cfg.head_dim
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    head_mask, vocab_mask = _masks(cfg, dev)
    x = _embed_tokens(top, token, mesh)                # (B, D)
    x = x + _sin_at(pos, cfg.d_model, dev).to(x.dtype)
    heads = _block(mesh, cfg.n_heads_padded)
    n_model = 1 if mesh is None else mesh.axis_size("model")
    enc_last = cache["xk"].shape[2] * n_model - 1
    for i in range(cfg.n_layers):
        # the cross-attention's K/V come from the cache: their projections
        # are not used, so not gathered
        lp = _layer(cfg, params, "dec", i, mesh, skip=("x_wk", "x_wv", "x_bv"))
        h = _ln_of(cfg, x[:, None], lp, "ln1")
        q, k, v = _proj_qkv(cfg, lp, h, h)
        o = Lyr.flash_decode(_model_gather(q[:, 0], 1, mesh), cache["k"][i], cache["v"][i],
                             k[:, 0], v[:, 0], pos, head_mask, Gp, mesh=mesh)
        bf = x.dtype
        x = x + Lyr.row_parallel(o[:, heads].reshape(B, -1), lp["wo"], mesh) + lp["bo"].to(bf)
        # cross-attention over the encoder's k/v, read only
        hx = _ln_of(cfg, x[:, None], lp, "lnx")
        qx = (hx @ lp["x_wq"].to(bf) + lp["x_bq"].to(bf)).reshape(B, -1, dh)
        ox = Lyr.flash_decode(_model_gather(qx, 1, mesh), cache["xk"][i], cache["xv"][i],
                              None, None, enc_last, head_mask, Gp, write=False, mesh=mesh)
        x = (x + Lyr.row_parallel(ox[:, heads].reshape(B, -1), lp["x_wo"], mesh)
             + lp["x_bo"].to(bf))
        x = x + _mlp(lp, _ln_of(cfg, x[:, None], lp, "ln2"), mesh)[:, 0]
    x = _ln_of(cfg, x[:, None], top, "ln_dec")
    cache["length"] = pos + 1
    return _logits(top, x, vocab_mask, mesh)[:, 0], cache


def train_loss(cfg: ModelConfig, params, batch: dict, mesh=None, dp=MESH_DP):
    """The mean next-token cross entropy of the decoder (JAX's
    ``train_loss``): ``batch["frames"]`` (B, S_enc, D) encoded, then
    ``batch["tokens"]`` and ``batch["labels"]`` (B, S) through the decoder
    over the whole sequence, each layer of both stacks rematerialised.  On
    a ``mesh``, the transformer's contract (``transformer.train_loss``):
    the global batch, frames included, in, split over every data axis of
    more than one rank, each layer's ``"data"`` blocks gathered inside its
    rematerialised body, the global mean out, the cross entropy
    vocabulary-parallel."""
    batch = _train_rows(mesh, batch, dp)
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    dev = batch["tokens"].device
    head_mask, vocab_mask = _masks(cfg, dev)
    enc = _encode(cfg, params, top, batch["frames"], head_mask, train=True, mesh=mesh)
    x = _embed_dec(cfg, top, batch["tokens"], mesh)
    entries = _dec_layer(cfg)
    block = make_remat(cfg, lambda lp, x: _dec_block(cfg, _gathered(entries, lp, mesh), x, enc,
                                                     head_mask, mesh)[0])
    for lp in layer_slices(params["dec"], cfg.n_layers):
        x = block(lp, x)
    x = _ln_of(cfg, x, top, "ln_dec")
    return _ce_loss(_logits(top, x, vocab_mask, mesh, gather=False), batch["labels"], mesh, dp)
