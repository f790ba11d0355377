"""Decoder-only LM stack of the port: dense GQA, MoE and VLM (embeds-input)
families (``repro.models.transformer``), for serving and training.

Parameters are a plain tree with the JAX package's names, shapes and
layout: ``{"top": {name: tensor}, "groups": [{name: (n_groups, ...)}]}``,
one stacked sub-tree a position of the repeating layer group
(``moe_interleave`` 2 makes a group [dense, moe]).  Layers run in a Python
loop where JAX scans.  Activations are bf16 from the embedding gather on;
a weight is cast to the activation dtype at its use, as JAX's ``wcast``
does, which is free for the bf16 weights ``init`` and ``params_from_jax``
make: the port casts once at load, JAX at every use, to the same values.

Entry points: ``param_shapes`` (no allocation), ``init`` (seeded random
weights on a device; float32 masters with ``masters=True``),
``alloc_cache``, ``prefill`` (prompt → last-token logits and a cache of
``max_seq`` slots), ``decode_step`` (one token, the cache written in place
at its position) and ``train_loss`` (the mean next-token cross entropy
over a full sequence, each layer group rematerialised as JAX's scan body
is).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models import layers as Lyr
from repro_torch.models.base import ModelConfig, ParamFactory, layer_slices, make_remat

F32_ENTRIES = frozenset()  # every entry is cast to the activations' dtype at its use

# --------------------------------------------------------------------------
# parameter tree
# --------------------------------------------------------------------------


def _layer_entries(cfg: ModelConfig, moe_layer: bool) -> dict:
    """{name: (shape, init kind)} for one block."""
    D, dh = cfg.d_model, cfg.head_dim
    KVp, Gp = cfg.padded_heads
    Hp = KVp * Gp
    F = cfg.d_ff
    e = {
        "ln1": ((D,), "ones"),
        "ln2": ((D,), "ones"),
        "wq": ((D, Hp * dh), "dense"),
        "wk": ((D, KVp * dh), "dense"),
        "wv": ((D, KVp * dh), "dense"),
        "wo": ((Hp * dh, D), "dense"),
    }
    if cfg.norm == "layernorm":
        e["ln1_b"] = ((D,), "zeros")
        e["ln2_b"] = ((D,), "zeros")
    if cfg.qkv_bias:
        e["bq"] = ((Hp * dh,), "zeros")
        e["bk"] = ((KVp * dh,), "zeros")
        e["bv"] = ((KVp * dh,), "zeros")
    if cfg.qk_norm:
        e["q_norm"] = ((dh,), "ones")
        e["k_norm"] = ((dh,), "ones")
    if moe_layer:
        E = cfg.n_experts
        e["router"] = ((D, E), "dense")
        e["w_in"] = ((E, D, F), "dense")
        e["w_gate"] = ((E, D, F), "dense")
        e["w_out"] = ((E, F, D), "dense")
    else:
        e["wi"] = ((D, F), "dense")
        e["wg"] = ((D, F), "dense")
        e["wod"] = ((F, D), "dense")
    return e


def _top_entries(cfg: ModelConfig) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    e = {"embed": ((Vp, D), "dense"), "ln_f": ((D,), "ones")}
    if cfg.norm == "layernorm":
        e["ln_f_b"] = ((D,), "zeros")
    if not cfg.tie_embeddings:
        e["head"] = ((D, Vp), "dense")
    return e


def group_flags(cfg: ModelConfig) -> list[bool]:
    """MoE flag a position of the repeating layer group."""
    if cfg.family != "moe" or cfg.n_experts == 0:
        return [False]
    return [(i % cfg.moe_interleave) == (cfg.moe_interleave - 1)
            for i in range(cfg.moe_interleave)]


def _n_groups(cfg: ModelConfig) -> int:
    group = len(group_flags(cfg))
    if cfg.n_layers % group:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into "
                         f"groups of {group}")
    return cfg.n_layers // group


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (JAX's ``abstract_init``), no allocation."""
    ng = _n_groups(cfg)
    return {
        "top": {k: shape for k, (shape, _) in _top_entries(cfg).items()},
        "groups": [{k: (ng,) + shape for k, (shape, _) in _layer_entries(cfg, f).items()}
                   for f in group_flags(cfg)],
    }


def init(cfg: ModelConfig, seed: int = 0, device="cuda", masters: bool = False) -> dict:
    """Seeded random weights on ``device``, in bf16 (float32 with
    ``masters``): normal × fan_in^-0.5 with JAX's fan-in (the per-layer
    shape's second-to-last dimension), ones and zeros."""
    pf = ParamFactory(seed, device, masters=masters)
    ng = _n_groups(cfg)
    return {
        "top": {k: pf.make(k, shape, kind) for k, (shape, kind) in _top_entries(cfg).items()},
        "groups": [{k: pf.make(k, (ng,) + shape, kind)
                    for k, (shape, kind) in _layer_entries(cfg, f).items()}
                   for f in group_flags(cfg)],
    }


def alloc_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """Zeroed decode cache: a dict a group position with k/v (n_groups, B,
    max_seq, KVp, dh) in bf16, or int8 with float32 scales ks/vs (n_groups,
    B, max_seq, KVp); ``length`` is the number of filled positions."""
    KVp, _ = cfg.padded_heads
    shape = (_n_groups(cfg), batch, max_seq, KVp, cfg.head_dim)
    int8 = cfg.kv_cache_dtype == "int8"
    layers = []
    for _ in group_flags(cfg):
        entry = {n: torch.zeros(shape, dtype=torch.int8 if int8 else torch.bfloat16,
                                device=device) for n in ("k", "v")}
        if int8:
            entry.update({n: torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                          for n in ("ks", "vs")})
        layers.append(entry)
    return {"layers": layers, "length": 0}


# --------------------------------------------------------------------------
# forward blocks
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _masks(cfg: ModelConfig, device: torch.device):
    """(head mask (Hp,), vocab mask (Vp,)) on ``device``, made once."""
    return (cfg.head_mask().reshape(-1).to(device),
            cfg.vocab_mask().to(device))


def _norm(cfg, x, p, prefix):
    if cfg.norm == "layernorm":
        return Lyr.layernorm(x, p[prefix], p[prefix + "_b"], cfg.norm_eps)
    return Lyr.rmsnorm(x, p[prefix], cfg.norm_eps)


def _qkv(cfg: ModelConfig, lp, h, positions):
    """h: (B, S, D) -> q (B, S, Hp, dh), k/v (B, S, KVp, dh); qk-norm + rope."""
    KVp, Gp = cfg.padded_heads
    dh = cfg.head_dim
    B, S, _ = h.shape
    q = h @ lp["wq"].to(h.dtype)
    k = h @ lp["wk"].to(h.dtype)
    v = h @ lp["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(h.dtype)
        k = k + lp["bk"].to(h.dtype)
        v = v + lp["bv"].to(h.dtype)
    q = q.reshape(B, S, KVp * Gp, dh)
    k = k.reshape(B, S, KVp, dh)
    v = v.reshape(B, S, KVp, dh)
    if cfg.qk_norm:
        q = Lyr.rmsnorm(q, lp["q_norm"], cfg.norm_eps)
        k = Lyr.rmsnorm(k, lp["k_norm"], cfg.norm_eps)
    return Lyr.rope(q, positions, cfg.rope_theta), Lyr.rope(k, positions, cfg.rope_theta), v


def _mlp(cfg: ModelConfig, lp, h, moe_layer: bool, stats):
    if moe_layer:
        return Lyr.moe_block(h, lp["router"], lp["w_in"], lp["w_gate"], lp["w_out"],
                             top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                             stats=stats)
    return Lyr.swiglu(h, lp["wi"], lp["wg"], lp["wod"])


def _layers(cfg: ModelConfig, params):
    """(position in group, MoE flag, layer params) for every layer in order."""
    for g in range(_n_groups(cfg)):
        for j, flag in enumerate(group_flags(cfg)):
            yield j, g, flag, {k: t[g] for k, t in params["groups"][j].items()}


def _embed_tokens(top, tokens):
    """The bf16 rows of ``tokens``: JAX casts the table, then gathers; the
    port gathers, then casts (the same values; the gradient sums repeated
    tokens in float32)."""
    return top["embed"][tokens].to(torch.bfloat16)


def _logits(cfg, top, x, vocab_mask):
    head = top["embed"].T if cfg.tie_embeddings else top["head"]
    return (x @ head.to(x.dtype)).float() + vocab_mask


def _ce_loss(logits, labels):
    """Mean cross entropy over ``labels >= 0`` (JAX's ``_ce_loss``; a VLM's
    or an audio prefix carries -1): logits (B, S, Vp) float32 with the vocab
    mask added, labels (B, S) integers."""
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, logz - ll, torch.zeros((), dtype=logits.dtype,
                                                   device=logits.device))
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)


def _block_full(cfg: ModelConfig, head_mask, moe_layer: bool, x, lp, positions, stats=None):
    """One block over the full sequence x (B, S, D) -> (x, k, v)."""
    B, S, _ = x.shape
    h = _norm(cfg, x, lp, "ln1")
    q, k, v = _qkv(cfg, lp, h, positions)
    o = Lyr.attention_full(q, k, v, head_mask, group_size=cfg.padded_heads[1],
                           causal=True, window=cfg.local_window, q_chunk=cfg.q_chunk)
    x = x + o.reshape(B, S, -1) @ lp["wo"].to(x.dtype)
    x = x + _mlp(cfg, lp, _norm(cfg, x, lp, "ln2"), moe_layer, stats)
    return x, k, v


def _prompt(cfg, top, batch):
    """The embedded prompt (B, S, D) bf16: a VLM's ``embeds`` first."""
    x = _embed_tokens(top, batch["tokens"])
    if cfg.family == "vlm" and "embeds" in batch:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
    return x


def _write_prefill_kv(cfg, entry, g, k, v):
    S = k.shape[1]
    if cfg.kv_cache_dtype == "int8":
        k, ks = Lyr.quantize_kv(k)
        v, vs = Lyr.quantize_kv(v)
        entry["ks"][g, :, :S] = ks
        entry["vs"][g, :, :S] = vs
    entry["k"][g, :, :S] = k
    entry["v"][g, :, :S] = v


# --------------------------------------------------------------------------
# public model functions
# --------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, batch: dict, max_seq: int | None = None,
            stats: dict | None = None):
    """Prompt -> (last-token logits (B, Vp) float32 with ``vocab_mask``, a
    cache of ``max_seq`` positions (default: the prompt's) filled to S).

    ``batch["tokens"]``: (B, S_text) integers; a VLM's ``batch["embeds"]``
    (B, P, D) is prepended to the token embeddings (S = P + S_text).
    """
    top = params["top"]
    dev = batch["tokens"].device
    x = _prompt(cfg, top, batch)
    B, S, _ = x.shape
    head_mask, vocab_mask = _masks(cfg, dev)
    cache = alloc_cache(cfg, B, max_seq or S, dev)
    positions = torch.arange(S, device=dev)
    for j, g, moe_layer, lp in _layers(cfg, params):
        x, k, v = _block_full(cfg, head_mask, moe_layer, x, lp, positions, stats)
        _write_prefill_kv(cfg, cache["layers"][j], g, k, v)
    x = _norm(cfg, x[:, -1:, :], top, "ln_f")
    cache["length"] = S
    return _logits(cfg, top, x, vocab_mask)[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache: dict, token, stats: dict | None = None):
    """One serving step: token (B,) integers at position ``pos =
    cache["length"]`` -> (logits (B, Vp) float32, the cache, written in
    place at ``pos``, with ``length`` pos + 1)."""
    pos = cache["length"]
    top = params["top"]
    dev = token.device
    head_mask, vocab_mask = _masks(cfg, dev)
    x = _embed_tokens(top, token)                                 # (B, D)
    B = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int64, device=dev)
    int8 = cfg.kv_cache_dtype == "int8"
    for j, g, moe_layer, lp in _layers(cfg, params):
        kv = cache["layers"][j]
        h = _norm(cfg, x[:, None, :], lp, "ln1")
        q, k, v = _qkv(cfg, lp, h, positions)
        o = Lyr.flash_decode(
            q[:, 0], kv["k"][g], kv["v"][g], k[:, 0], v[:, 0], pos, head_mask,
            cfg.padded_heads[1],
            k_scale=kv["ks"][g] if int8 else None, v_scale=kv["vs"][g] if int8 else None)
        x = x + o.reshape(B, -1) @ lp["wo"].to(x.dtype)
        h2 = _norm(cfg, x[:, None, :], lp, "ln2")
        x = x + _mlp(cfg, lp, h2, moe_layer, stats)[:, 0]
    x = _norm(cfg, x[:, None, :], top, "ln_f")
    cache["length"] = pos + 1
    return _logits(cfg, top, x, vocab_mask)[:, 0], cache


def train_loss(cfg: ModelConfig, params, batch: dict):
    """The mean next-token cross entropy (JAX's ``train_loss``):
    ``batch["tokens"]`` (B, S_text), ``batch["labels"]`` (B, S) with S the
    text plus a VLM's ``embeds`` (B, P, D) prepended.  A full-sequence stack
    with no cache, each layer group (one block, or [dense, MoE]) the body
    JAX scans and rematerialises; logits at every position."""
    top = params["top"]
    dev = batch["tokens"].device
    x = _prompt(cfg, top, batch)
    head_mask, vocab_mask = _masks(cfg, dev)
    positions = torch.arange(x.shape[1], device=dev)
    flags = group_flags(cfg)
    ng = _n_groups(cfg)

    def body(x, lps):
        for flag, lp in zip(flags, lps):
            x = _block_full(cfg, head_mask, flag, x, lp, positions)[0]
        return x

    body = make_remat(cfg, body)
    groups = [layer_slices(g, ng) for g in params["groups"]]
    for i in range(ng):
        x = body(x, [g[i] for g in groups])
    x = _norm(cfg, x, top, "ln_f")
    return _ce_loss(_logits(cfg, top, x, vocab_mask), batch["labels"])
