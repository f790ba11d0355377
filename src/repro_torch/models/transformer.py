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

Entry points: ``param_shapes`` and ``param_specs`` (the shardings the
JAX package gives each parameter; no allocation), ``init`` (seeded random
weights on a device; float32 masters with ``masters=True``),
``cache_specs`` and ``alloc_cache``, ``prefill`` (prompt → last-token logits and a cache of
``max_seq`` slots), ``decode_step`` (one token, the cache written in place
at its position) and ``train_loss`` (the mean next-token cross entropy
over a full sequence, each layer group rematerialised as JAX's scan body
is).

**On a device mesh** (``mesh=``, a ``launch.mesh.RankMesh``), every rank
calls ``init``/``params_from_jax``, ``alloc_cache``, ``prefill``,
``decode_step`` and ``train_loss`` with the same arguments and holds its
shards, as each device does in JAX's partitioned program:

* weights by ``param_specs``: a ``"data"`` block is gathered at its use
  (``base.wcast``, the FSDP gather), a ``"model"`` block is used as it is:
  q heads, the MLP's d_ff and the vocabulary split over ``"model"``
  (column-parallel products), ``wo``/``wod`` row-parallel
  (``layers.row_parallel``), the embedding gathered vocabulary-parallel;
* the batch split over ``dp``, JAX's argument (``base.batch_axes``; by
  default ``("pod", "data")``, ``base.dp_spec``): the global batch goes in,
  each rank computes its data shard's rows and returns their logits
  (B / data, Vp), as JAX's come back split over the batch; ``dp=None``
  keeps the whole batch on every rank;
* the cache by ``cache_specs``: ``Smax / model`` slots a rank, written by
  ``prefill`` where the rank owns them and read by the sequence-sharded
  ``layers.flash_decode``; MoE layers run ``layers.moe_block`` with each
  rank's ``E / model`` experts and a capacity counted from its shard's
  tokens, as JAX's ``_moe_local`` does;
* ``train_loss``'s gradient flows back through the same collectives
  (``distributed.collectives``): an FSDP gather's gradient is
  reduce-scattered to the shard, the vocabulary-parallel cross entropy's
  sums pass it to this rank's block of the logits (never gathered whole),
  a row-parallel sum's passes through, and a tensor
  whole on every ``"model"`` rank that feeds its block of the heads, the
  d_ff columns, the experts or the vocabulary has its gradient summed over
  ``"model"``; ``train.loop`` sums the other leaves' over the data axes.

A batch that the data axes do not divide, or a cache whose ``Smax`` the
``"model"`` axis does not divide, raises ``ValueError`` naming both
numbers; nothing is padded.  Without a mesh these functions compute what
they computed before meshes existed, to the bit, and with one rank on
each axis too.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models import layers as Lyr
from repro_torch.models.base import (
    MESH_DP,
    ModelConfig,
    ParamFactory,
    _axis_names,
    _block,
    _embed_tokens,
    _gathered,
    _logits,
    _model_gather,
    _model_grad_sum,
    _rows,
    _split,
    _train_rows,
    batch_axes,
    full_spec,
    layer_slices,
    make_remat,
    rank_specs,
    zeros_of,
)

F32_ENTRIES = frozenset()  # every entry is cast to the activations' dtype at its use

# --------------------------------------------------------------------------
# parameter tree
# --------------------------------------------------------------------------


def _layer_entries(cfg: ModelConfig, moe_layer: bool) -> dict:
    """{name: (shape, init kind, sharding)} for one block; the sharding is
    JAX's (``base.full_spec``)."""
    D, dh = cfg.d_model, cfg.head_dim
    KVp, Gp = cfg.padded_heads
    Hp = KVp * Gp
    F = cfg.d_ff
    e = {
        "ln1": ((D,), "ones", None),
        "ln2": ((D,), "ones", None),
        "wq": ((D, Hp * dh), "dense", ("data", "model")),
        "wk": ((D, KVp * dh), "dense", ("data", None)),
        "wv": ((D, KVp * dh), "dense", ("data", None)),
        "wo": ((Hp * dh, D), "dense", ("model", "data")),
    }
    if cfg.norm == "layernorm":
        e["ln1_b"] = ((D,), "zeros", None)
        e["ln2_b"] = ((D,), "zeros", None)
    if cfg.qkv_bias:
        e["bq"] = ((Hp * dh,), "zeros", ("model",))
        e["bk"] = ((KVp * dh,), "zeros", None)
        e["bv"] = ((KVp * dh,), "zeros", None)
    if cfg.qk_norm:
        e["q_norm"] = ((dh,), "ones", None)
        e["k_norm"] = ((dh,), "ones", None)
    if moe_layer:
        E = cfg.n_experts
        e["router"] = ((D, E), "dense", ("data", None))
        e["w_in"] = ((E, D, F), "dense", ("model", "data", None))
        e["w_gate"] = ((E, D, F), "dense", ("model", "data", None))
        e["w_out"] = ((E, F, D), "dense", ("model", None, "data"))
    else:
        e["wi"] = ((D, F), "dense", ("data", "model"))
        e["wg"] = ((D, F), "dense", ("data", "model"))
        e["wod"] = ((F, D), "dense", ("model", "data"))
    return e


def _top_entries(cfg: ModelConfig) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    e = {"embed": ((Vp, D), "dense", ("model", "data")), "ln_f": ((D,), "ones", None)}
    if cfg.norm == "layernorm":
        e["ln_f_b"] = ((D,), "zeros", None)
    if not cfg.tie_embeddings:
        e["head"] = ((D, Vp), "dense", ("data", "model"))
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
        "top": {k: shape for k, (shape, _, _) in _top_entries(cfg).items()},
        "groups": [{k: (ng,) + shape for k, (shape, _, _) in _layer_entries(cfg, f).items()}
                   for f in group_flags(cfg)],
    }


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's shardings (JAX's ``param_specs``), one entry a
    dimension, the stacked layer axis replicated."""
    return {
        "top": {k: full_spec(spec, len(shape))
                for k, (shape, _, spec) in _top_entries(cfg).items()},
        "groups": [{k: full_spec(spec, len(shape), stacked=True)
                    for k, (shape, _, spec) in _layer_entries(cfg, f).items()}
                   for f in group_flags(cfg)],
    }


def init(cfg: ModelConfig, seed: int = 0, device="cuda", masters: bool = False,
         mesh=None) -> dict:
    """Seeded random weights on ``device``, in bf16 (float32 with
    ``masters``): normal × fan_in^-0.5 with JAX's fan-in (the per-layer
    shape's second-to-last dimension), ones and zeros.  On a ``mesh``, this
    rank's shards (``base.shard``) of the same weights: each entry is drawn
    whole, in the same order, and cut at once."""
    pf = ParamFactory(seed, device, masters=masters)
    ng = _n_groups(cfg)
    return {
        "top": {k: pf.draw(k, shape, kind, spec, mesh)
                for k, (shape, kind, spec) in _top_entries(cfg).items()},
        "groups": [{k: pf.draw(k, (ng,) + shape, kind, spec, mesh, stacked=True)
                    for k, (shape, kind, spec) in _layer_entries(cfg, f).items()}
                   for f in group_flags(cfg)],
    }


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The decode cache's tensors as (shape, dtype, sharding), JAX's
    ``abstract_cache`` template (``"data"`` for the batch axis): a dict a
    group position with k/v (n_groups, B, max_seq, KVp, dh) in bf16, or
    int8 with float32 scales ks/vs (n_groups, B, max_seq, KVp)."""
    KVp, _ = cfg.padded_heads
    shape = (_n_groups(cfg), batch, max_seq, KVp, cfg.head_dim)
    spec = (None, "data", "model", None, None)
    int8 = cfg.kv_cache_dtype == "int8"
    entry = {n: (shape, torch.int8 if int8 else torch.bfloat16, spec) for n in ("k", "v")}
    if int8:
        entry.update({n: (shape[:-1], torch.float32, spec[:-1]) for n in ("ks", "vs")})
    return {"layers": [dict(entry) for _ in group_flags(cfg)]}


def alloc_cache(cfg: ModelConfig, batch: int, max_seq: int, device, mesh=None,
                dp=MESH_DP) -> dict:
    """Zeroed decode cache of :func:`cache_specs`'s tensors; ``length`` is
    the number of filled positions.  On a ``mesh``, this rank's shards of
    the cache of the global ``batch`` (the batch over the axes ``dp``, by
    default ``("pod", "data")``; the slots over ``"model"``)."""
    specs = cache_specs(cfg, batch, max_seq)
    if mesh is not None:
        _split(mesh, batch, max_seq, dp)
        specs = rank_specs(specs, mesh, dp)
    return {**zeros_of(specs, device), "length": 0}


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


def _qkv(cfg: ModelConfig, lp, h, positions, mesh=None):
    """h: (B, S, D) -> q (B, S, Hp, dh), k/v (B, S, KVp, dh); qk-norm + rope.
    On a mesh q is this rank's block of the heads, and the gradients of h
    and ``q_norm`` through it are summed over ``"model"``."""
    KVp, Gp = cfg.padded_heads
    dh = cfg.head_dim
    B, S, _ = h.shape
    q = _model_grad_sum(h, mesh) @ lp["wq"].to(h.dtype)
    k = h @ lp["wk"].to(h.dtype)
    v = h @ lp["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(h.dtype)
        k = k + lp["bk"].to(h.dtype)
        v = v + lp["bv"].to(h.dtype)
    q = q.reshape(B, S, -1, dh)  # KVp * Gp heads, or this rank's block of them
    k = k.reshape(B, S, KVp, dh)
    v = v.reshape(B, S, KVp, dh)
    if cfg.qk_norm:
        q = Lyr.rmsnorm(q, _model_grad_sum(lp["q_norm"], mesh), cfg.norm_eps)
        k = Lyr.rmsnorm(k, lp["k_norm"], cfg.norm_eps)
    return Lyr.rope(q, positions, cfg.rope_theta), Lyr.rope(k, positions, cfg.rope_theta), v


def _mlp(cfg: ModelConfig, lp, h, moe_layer: bool, stats, mesh=None):
    if moe_layer:
        return Lyr.moe_block(h, lp["router"], lp["w_in"], lp["w_gate"], lp["w_out"],
                             top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                             stats=stats, mesh=mesh)
    return Lyr.swiglu(h, lp["wi"], lp["wg"], lp["wod"], mesh)


def _layers(cfg: ModelConfig, params, mesh=None):
    """(position in group, MoE flag, layer params) for every layer in order;
    on a mesh with each weight's ``"data"`` blocks gathered."""
    for g in range(_n_groups(cfg)):
        for j, flag in enumerate(group_flags(cfg)):
            lp = {k: t[g] for k, t in params["groups"][j].items()}
            yield j, g, flag, _gathered(_layer_entries(cfg, flag), lp, mesh)


def _ce_loss(logits, labels, mesh=None, dp=MESH_DP):
    """Mean cross entropy over ``labels >= 0`` (JAX's ``_ce_loss``; a VLM's
    or an audio prefix carries -1): logits (B, S, Vp) float32 with the vocab
    mask added, labels (B, S) integers.  On a ``mesh`` they are this rank's
    rows of the batch, split over the axes ``dp``: the kept labels are
    counted over those axes, each rank divides its own sum by that global
    count, and the quotients are summed over the axes (their gradient
    passing through unchanged), so every rank returns the mean over the
    global batch and differentiates its own rows' share of it.

    With more than one ``"model"`` rank the logits are this rank's
    vocabulary block (B, S, Vp / model) (``base.vocab_logits(...,
    gather=False)``) and the loss is vocabulary-parallel, as JAX's
    partitioned ``_ce_loss`` reduces over the vocabulary's blocks: the row
    maximum (the blocks' maxima, an ``all_reduce(MAX)`` of values taken
    without a gradient: the log-sum-exp does not depend on the shift), the
    sum of ``exp(logit - max)`` and the label's logit (taken on the rank
    whose block holds the label, 0 elsewhere) are each summed over
    ``"model"``, whose gradient passes through to this rank's block.  With
    one ``"model"`` rank the block is the whole vocabulary and the loss is
    the unmeshed one's to the bit."""
    from repro_torch.distributed.collectives import all_reduce_max, all_reduce_sum

    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    if mesh is None or mesh.axis_size("model") == 1:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    else:
        group = mesh.group("model")
        n = logits.shape[-1]
        top = all_reduce_max(logits.detach().amax(dim=-1), group)
        logz = torch.log(all_reduce_sum(torch.sum(torch.exp(logits - top[..., None]), dim=-1),
                                        group)) + top
        ids = safe - mesh.axis_index("model") * n
        inside = (ids >= 0) & (ids < n)
        ll = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
        ll = all_reduce_sum(torch.where(inside, ll, torch.zeros((), dtype=ll.dtype,
                                                                device=ll.device)), group)
    nll = torch.where(mask, logz - ll, torch.zeros((), dtype=logits.dtype,
                                                   device=logits.device))
    axes = [] if mesh is None else [a for a in _axis_names(batch_axes(mesh, dp))
                                    if mesh.axis_size(a) > 1]
    count = torch.sum(mask)
    for a in axes:
        count = all_reduce_sum(count, mesh.group(a))
    loss = torch.sum(nll) / torch.clamp(count, min=1)
    for a in axes:
        loss = all_reduce_sum(loss, mesh.group(a))
    return loss


def _block_full(cfg: ModelConfig, head_mask, moe_layer: bool, x, lp, positions, stats=None,
                mesh=None):
    """One block over the full sequence x (B, S, D) -> (x, k, v); on a mesh
    the q heads are this rank's block (k and v whole)."""
    B, S, _ = x.shape
    heads = _block(mesh, cfg.n_heads_padded)  # refuses heads the mesh cannot split
    h = _norm(cfg, x, lp, "ln1")
    q, k, v = _qkv(cfg, lp, h, positions, mesh)
    # k and v are whole on every rank and feed its block of the heads
    o = Lyr.attention_full(q, _model_grad_sum(k, mesh), _model_grad_sum(v, mesh),
                           head_mask[heads], group_size=cfg.padded_heads[1],
                           causal=True, window=cfg.local_window, q_chunk=cfg.q_chunk,
                           heads=heads)
    x = x + Lyr.row_parallel(o.reshape(B, S, -1), lp["wo"], mesh)
    x = x + _mlp(cfg, lp, _norm(cfg, x, lp, "ln2"), moe_layer, stats, mesh)
    return x, k, v


def _prompt(cfg, top, batch, mesh=None):
    """The embedded prompt (B, S, D) bf16: a VLM's ``embeds`` first."""
    x = _embed_tokens(top, batch["tokens"], mesh)
    if cfg.family == "vlm" and "embeds" in batch:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
    return x


def _write_prefill_kv(cfg, entry, g, k, v, mesh=None):
    """The prompt's k/v (B, S, KVp, dh) into the cache's slots; on a mesh
    only the slots this rank holds, ``ax · s_loc ...`` on ``"model"``."""
    s_loc = entry["k"].shape[2]
    lo = 0 if mesh is None else mesh.axis_index("model") * s_loc
    hi = min(k.shape[1], lo + s_loc)
    if hi <= lo:
        return
    k, v = k[:, lo:hi], v[:, lo:hi]
    if cfg.kv_cache_dtype == "int8":
        k, ks = Lyr.quantize_kv(k)
        v, vs = Lyr.quantize_kv(v)
        entry["ks"][g, :, :hi - lo] = ks
        entry["vs"][g, :, :hi - lo] = vs
    entry["k"][g, :, :hi - lo] = k
    entry["v"][g, :, :hi - lo] = v


# --------------------------------------------------------------------------
# public model functions
# --------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, batch: dict, max_seq: int | None = None,
            stats: dict | None = None, mesh=None, dp=MESH_DP):
    """Prompt -> (last-token logits (B, Vp) float32 with ``vocab_mask``, a
    cache of ``max_seq`` positions (default: the prompt's) filled to S).

    ``batch["tokens"]``: (B, S_text) integers; a VLM's ``batch["embeds"]``
    (B, P, D) is prepended to the token embeddings (S = P + S_text).  On a
    ``mesh`` (module docstring): this rank's shards of the weights, the
    global batch in, the data shard's logits and cache shard out.
    """
    dev = batch["tokens"].device
    B = batch["tokens"].shape[0]
    max_seq = max_seq or batch["tokens"].shape[1] + (
        batch["embeds"].shape[1] if cfg.family == "vlm" and "embeds" in batch else 0)
    cache = alloc_cache(cfg, B, max_seq, dev, mesh, dp)
    batch = {k: _rows(mesh, t, dp) for k, t in batch.items()}
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    x = _prompt(cfg, top, batch, mesh)
    S = x.shape[1]
    head_mask, vocab_mask = _masks(cfg, dev)
    positions = torch.arange(S, device=dev)
    for j, g, moe_layer, lp in _layers(cfg, params, mesh):
        x, k, v = _block_full(cfg, head_mask, moe_layer, x, lp, positions, stats, mesh)
        _write_prefill_kv(cfg, cache["layers"][j], g, k, v, mesh)
    x = _norm(cfg, x[:, -1:, :], top, "ln_f")
    cache["length"] = S
    return _logits(cfg, top, x, vocab_mask, mesh)[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache: dict, token, stats: dict | None = None,
                mesh=None, dp=MESH_DP):
    """One serving step: token (B,) integers at position ``pos =
    cache["length"]`` -> (logits (B, Vp) float32, the cache, written in
    place at ``pos``, with ``length`` pos + 1).  On a ``mesh`` (module
    docstring): the global batch's tokens in, the data shard's logits out,
    the cache this rank's shard."""
    pos = cache["length"]
    dev = token.device
    token = _rows(mesh, token, dp)
    B = token.shape[0]
    if cache["layers"][0]["k"].shape[1] != B:
        raise ValueError(f"the cache holds {cache['layers'][0]['k'].shape[1]} rows, "
                         f"the token's shard {B}")
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    head_mask, vocab_mask = _masks(cfg, dev)
    x = _embed_tokens(top, token, mesh)                           # (B, D)
    positions = torch.full((1,), pos, dtype=torch.int64, device=dev)
    int8 = cfg.kv_cache_dtype == "int8"
    heads = _block(mesh, cfg.n_heads_padded)
    for j, g, moe_layer, lp in _layers(cfg, params, mesh):
        kv = cache["layers"][j]
        h = _norm(cfg, x[:, None, :], lp, "ln1")
        q, k, v = _qkv(cfg, lp, h, positions)
        q = _model_gather(q[:, 0], 1, mesh)
        o = Lyr.flash_decode(
            q, kv["k"][g], kv["v"][g], k[:, 0], v[:, 0], pos, head_mask,
            cfg.padded_heads[1],
            k_scale=kv["ks"][g] if int8 else None, v_scale=kv["vs"][g] if int8 else None,
            mesh=mesh)
        x = x + Lyr.row_parallel(o[:, heads].reshape(B, -1), lp["wo"], mesh)
        h2 = _norm(cfg, x[:, None, :], lp, "ln2")
        x = x + _mlp(cfg, lp, h2, moe_layer, stats, mesh)[:, 0]
    x = _norm(cfg, x[:, None, :], top, "ln_f")
    cache["length"] = pos + 1
    return _logits(cfg, top, x, vocab_mask, mesh)[:, 0], cache


def train_loss(cfg: ModelConfig, params, batch: dict, mesh=None, dp=MESH_DP):
    """The mean next-token cross entropy (JAX's ``train_loss``):
    ``batch["tokens"]`` (B, S_text), ``batch["labels"]`` (B, S) with S the
    text plus a VLM's ``embeds`` (B, P, D) prepended.  A full-sequence stack
    with no cache, each layer group (one block, or [dense, MoE]) the body
    JAX scans and rematerialises; logits at every position.

    On a ``mesh`` (JAX's jitted step under ``param_specs`` and the batch's
    ``P(dp)``: FSDP over the data axes, tensor parallel over ``"model"``)
    every rank passes the global batch and its shards of the masters, and
    runs its data shard's rows (``dp`` must split the batch over every data
    axis of more than one rank).  A layer's weights are gathered inside the
    rematerialised body, so the backward gathers them again, as JAX's
    ``remat_policy="none"`` does.  The returned loss is the global batch's
    mean on every rank; its gradient is this rank's rows' share, in which a
    weight gathered over ``"data"`` has its gradient reduce-scattered back
    to the shard (``collectives.all_gather_dim``) and every other leaf holds
    a partial sum over the data axes (``train.loop`` sums it).  The logits
    stay this rank's vocabulary block: the cross entropy is
    vocabulary-parallel (:func:`_ce_loss`), and no rank holds them whole."""
    batch = _train_rows(mesh, batch, dp)
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    dev = batch["tokens"].device
    x = _prompt(cfg, top, batch, mesh)
    head_mask, vocab_mask = _masks(cfg, dev)
    positions = torch.arange(x.shape[1], device=dev)
    flags = group_flags(cfg)
    entries = [_layer_entries(cfg, f) for f in flags]
    ng = _n_groups(cfg)

    def body(x, lps):
        for flag, e, lp in zip(flags, entries, lps):
            x = _block_full(cfg, head_mask, flag, x, _gathered(e, lp, mesh), positions,
                            mesh=mesh)[0]
        return x

    body = make_remat(cfg, body)
    groups = [layer_slices(g, ng) for g in params["groups"]]
    for i in range(ng):
        x = body(x, [g[i] for g in groups])
    x = _norm(cfg, x, top, "ln_f")
    return _ce_loss(_logits(cfg, top, x, vocab_mask, mesh, gather=False), batch["labels"],
                    mesh, dp)
