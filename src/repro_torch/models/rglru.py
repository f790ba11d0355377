"""RecurrentGemma / Griffin hybrid of the port (``repro.models.rglru``):
RG-LRU recurrent blocks and local MQA attention in a repeating (rglru,
rglru, attn) pattern, for serving and training.

RG-LRU: ``h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)`` with
``a_t = exp(-c · softplus(Λ) ⊙ r_t)``.  The recurrence runs as JAX's
``lax.associative_scan`` does, the same odd/even recursion and so the same
products in the same order (``_associative_scan``); decode folds the
carried state in as a virtual step 0, as JAX does.

The layers are declared as segments: 38 layers are 12 × (rglru, rglru,
attn) + 1 × (rglru, rglru).  Parameters: ``{"top": {embed, ln_f, head},
"segments": [[{name: (reps, ...)} a pattern position] a segment]}``, the
JAX package's tree, in bf16 but ``F32_ENTRIES`` (Λ ``lam`` and the gates
``gate_r``, ``gate_i``: fp32 masters in JAX, used with no cast); for
training every entry is a float32 master (``masters=True``), cast at its
use.  ``train_loss`` runs the whole sequence from zero carries, each
repeat of a segment's pattern rematerialised (JAX's scan body), and never
allocates or writes a cache.

The cache: an rglru layer carries its conv inputs ``conv`` (reps, B, 3, R)
bf16 and its state ``lru`` (reps, B, R) f32; an attention layer a ring
buffer ``k``/``v`` (reps, B, W, KVp, dh) bf16 of W = ``local_window``
slots, a key at position p in slot p % W.  Nothing depends on ``max_seq``.

**On a device mesh** (``mesh=``, a ``launch.mesh.RankMesh``), every rank
calls ``init``/``params_from_jax``, ``alloc_cache``, ``prefill``,
``decode_step`` and ``train_loss`` with the same arguments and holds its
shards by ``param_specs`` and ``cache_specs`` (JAX's ``abstract_init`` and
``abstract_cache``); a weight's ``"data"`` blocks are gathered at its use
(``base.wcast``).  The residual stream is whole on every ``"model"`` rank
and the batch split over ``dp`` (``base.batch_axes``; ``dp=None`` keeps
it whole):

* an RG-LRU block runs on the rank's block of d_rnn: ``w_a`` and ``w_b``
  are column-parallel, ``conv``, Λ and the gates the rank's block, so the
  causal conv and the associative scan are local, and so are the cache's
  ``conv`` and ``lru``; ``w_out`` is row-parallel (``layers.row_parallel``,
  a float32 sum over ``"model"``);
* an attention block runs on the rank's q heads (``wq`` column-parallel,
  ``wo`` row-parallel); ``wk`` and ``wv`` are whole on every rank, so
  each rank computes the whole K/V head and holds the whole ring, every
  rank writing the same slot ``pos % W``;
* the MLP is ``layers.swiglu`` on the rank's block of d_ff;
* ``train_loss`` (FSDP over the data axes, tensor parallel over
  ``"model"``, as JAX's jitted step) keeps the transformer's contract, the
  cross entropy vocabulary-parallel; the gradients of the tensors whole
  on every ``"model"`` rank that feed its block are summed over
  ``"model"`` (``base._model_grad_sum``): an RG-LRU block's normed input
  (``w_a``, ``w_b``), an attention block's q input, its k and v, and the
  MLP's input.

A batch that the data axes ``dp`` do not divide raises ``ValueError``
naming both numbers.  Without a mesh, and on one rank on each axis, every
function computes what it computed before meshes existed, to the bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as Lyr
from repro_torch.models.base import (
    MESH_DP,
    ModelConfig,
    ParamFactory,
    _block,
    _embed_tokens,
    _gathered,
    _logits,
    _model_grad_sum,
    _rows,
    _split,
    _train_rows,
    full_spec,
    layer_slices,
    make_remat,
    rank_specs,
    zeros_of,
)
from repro_torch.models.transformer import _ce_loss, _masks, _qkv

CONV_WIDTH = 4
LRU_C = 8.0
F32_ENTRIES = frozenset({"lam", "gate_r", "gate_i"})


def segments(cfg: ModelConfig):
    """[(pattern tuple, n_repeats)] covering cfg.n_layers."""
    pat = cfg.pattern or ("rglru", "rglru", "attn")
    full, rem = divmod(cfg.n_layers, len(pat))
    segs = [(pat, full)]
    if rem:
        segs.append((pat[:rem], 1))
    return segs


def _d_rnn(cfg):
    return cfg.d_rnn or cfg.d_model


def _entries(cfg: ModelConfig, kind: str) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    R = _d_rnn(cfg)
    col, row = ("data", "model"), ("model", "data")
    e = {"ln1": ((D,), "ones", None), "ln2": ((D,), "ones", None),
         "wi": ((D, F_), "dense", col), "wg": ((D, F_), "dense", col),
         "wod": ((F_, D), "dense", row)}
    if kind == "rglru":
        e.update({
            "w_a": ((D, R), "dense", col),       # gelu branch
            "w_b": ((D, R), "dense", col),       # recurrent branch
            "w_out": ((R, D), "dense", row),
            "conv": ((CONV_WIDTH, R), "zeros", (None, "model")),
            "lam": ((R,), "ones", ("model",)),         # Λ
            "gate_r": ((R,), "zeros", ("model",)),     # diagonal recurrence gate
            "gate_i": ((R,), "zeros", ("model",)),     # diagonal input gate
        })
    else:  # local MQA attention
        KVp, Gp = cfg.padded_heads
        dh = cfg.head_dim
        e.update({"wq": ((D, KVp * Gp * dh), "dense", col),
                  "wk": ((D, KVp * dh), "dense", ("data", None)),
                  "wv": ((D, KVp * dh), "dense", ("data", None)),
                  "wo": ((KVp * Gp * dh, D), "dense", row)})
    return e


def _top_entries(cfg: ModelConfig) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    return {"embed": ((Vp, D), "dense", ("model", "data")), "ln_f": ((D,), "ones", None),
            "head": ((D, Vp), "dense", ("data", "model"))}


def param_shapes(cfg: ModelConfig) -> dict:
    """JAX's ``abstract_init`` tree, no allocation."""
    return {"top": {k: s for k, (s, _, _) in _top_entries(cfg).items()},
            "segments": [[{k: (reps,) + s for k, (s, _, _) in _entries(cfg, kind).items()}
                          for kind in pat] for pat, reps in segments(cfg)]}


def param_specs(cfg: ModelConfig) -> dict:
    """JAX's ``param_specs`` tree, one entry a dimension (``full_spec``)."""
    return {"top": {k: full_spec(sp, len(s)) for k, (s, _, sp) in _top_entries(cfg).items()},
            "segments": [[{k: full_spec(sp, len(s), stacked=True)
                           for k, (s, _, sp) in _entries(cfg, kind).items()}
                          for kind in pat] for pat, _ in segments(cfg)]}


def init(cfg: ModelConfig, seed: int = 0, device="cuda", masters: bool = False,
         mesh=None) -> dict:
    """Seeded random weights on ``device`` (bf16, ``F32_ENTRIES`` float32;
    every entry float32 with ``masters``).  On a ``mesh``, this rank's
    shards (``base.shard``) of the same weights: each entry is drawn whole,
    in the same order, and cut at once."""
    pf = ParamFactory(seed, device, F32_ENTRIES, masters)
    return {"top": {k: pf.draw(k, s, kind, sp, mesh)
                    for k, (s, kind, sp) in _top_entries(cfg).items()},
            "segments": [[{k: pf.draw(k, (reps,) + s, kind, sp, mesh, stacked=True)
                           for k, (s, kind, sp) in _entries(cfg, kind_).items()}
                          for kind_ in pat] for pat, reps in segments(cfg)]}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The cache's tensors as (shape, dtype, sharding), JAX's
    ``abstract_cache`` template (``"data"`` for the batch axis); ``max_seq``
    is unused: the state is O(window + d_rnn)."""
    R, W, dh = _d_rnn(cfg), cfg.local_window, cfg.head_dim
    KVp, _ = cfg.padded_heads
    bf16, kv = torch.bfloat16, (None, "data", None, None, None)
    return {"segments": [[
        {"conv": ((reps, batch, CONV_WIDTH - 1, R), bf16, (None, "data", None, "model")),
         "lru": ((reps, batch, R), torch.float32, (None, "data", "model"))}
        if kind == "rglru" else
        {"k": ((reps, batch, W, KVp, dh), bf16, kv), "v": ((reps, batch, W, KVp, dh), bf16, kv)}
        for kind in pat] for pat, reps in segments(cfg)]}


def alloc_cache(cfg: ModelConfig, batch: int, max_seq: int, device, mesh=None,
                dp=MESH_DP) -> dict:
    """Zeroed cache of :func:`cache_specs`'s tensors.  On a ``mesh``, this
    rank's shards of the cache of the global ``batch`` (the batch over the
    axes ``dp``, d_rnn over ``"model"``; the ring whole)."""
    specs = cache_specs(cfg, batch, max_seq)
    if mesh is not None:
        _split(mesh, batch, dp=dp)
        _block(mesh, _d_rnn(cfg))  # an even d_rnn block a rank
        specs = rank_specs(specs, mesh, dp)
    return {"length": 0, **zeros_of(specs, device)}


# --------------------------------------------------------------------------
# RG-LRU temporal mixing
# --------------------------------------------------------------------------


def _causal_conv(x, kernel, state):
    """Depthwise causal conv of width W over x (B, S, R) bf16 with the
    carried last W-1 inputs ``state`` (B, W-1, R) -> (out, new state)."""
    W = kernel.shape[0]
    xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i : i + x.shape[1]] * kernel[i][None, None, :].to(x.dtype)
              for i in range(W))
    return out, xp[:, -(W - 1):]


def _combine(left, right):
    """(a_l, b_l) then (a_r, b_r): h = a_r (a_l h + b_l) + b_r."""
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _associative_scan(elems):
    """Inclusive scan of ``_combine`` along dim 1, computed as
    ``jax.lax.associative_scan`` computes it: combine adjacent pairs,
    recurse on the pairs, then fill in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):  # interleave: even positions, then odd
        o = torch.empty((ev.shape[0], n) + ev.shape[2:], dtype=ev.dtype, device=ev.device)
        o[:, 0::2] = ev
        o[:, 1::2] = od
        out.append(o)
    return out


def _rglru_scan(x, a, h0=None):
    """h_t = a_t h_{t-1} + x_t over dim 1 -> (h (B, S, R), h_S).  A carried
    h0 (B, R) is folded in as a virtual step 0 with a = 0, as in JAX."""
    if h0 is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        x = torch.cat([h0[:, None, :], x], dim=1)
    _, h = _associative_scan([a, x])
    return (h[:, 1:], h[:, -1]) if h0 is not None else (h, h[:, -1])


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _rglru_block(cfg, lp, h, conv_state, lru_state=None, mesh=None):
    """h: (B, S, D) normed input -> (out (B, S, D), conv state, lru state);
    on a mesh the branch runs on the rank's d_rnn block and the output is
    summed over ``"model"``, h's gradient too."""
    bf = h.dtype
    h = _model_grad_sum(h, mesh)  # whole on every rank, it feeds w_a's and w_b's blocks
    a_br = F.gelu(h @ lp["w_a"].to(bf), approximate="tanh")  # jax.nn.gelu's default
    b, conv_state = _causal_conv(h @ lp["w_b"].to(bf), lp["conv"], conv_state)
    bf32 = b.float()
    r = torch.sigmoid(bf32 * lp["gate_r"])
    i = torch.sigmoid(bf32 * lp["gate_i"])
    a = torch.exp(-LRU_C * _softplus(lp["lam"]) * r)            # (B, S, R) f32
    gated = torch.sqrt(torch.clamp(1.0 - a ** 2, min=1e-9)) * (i * bf32)
    hseq, lru_state = _rglru_scan(gated, a, lru_state)
    return Lyr.row_parallel(hseq.to(bf) * a_br, lp["w_out"], mesh), conv_state, lru_state


# --------------------------------------------------------------------------
# local attention: the full sequence, and one step on the ring buffer
# --------------------------------------------------------------------------


def _attn_block_full(cfg, lp, h, positions, head_mask, mesh=None):
    """Windowed causal attention over h (B, S, D) -> (out, k, v); on a mesh
    over the rank's q heads (k and v whole, their gradients and q's input's
    summed over ``"model"``), the output summed over ``"model"``."""
    B, S, _ = h.shape
    heads = _block(mesh, cfg.n_heads_padded)
    q, k, v = _qkv(cfg, lp, h, positions, mesh)
    o = Lyr.attention_full(q, _model_grad_sum(k, mesh), _model_grad_sum(v, mesh),
                           head_mask[heads], group_size=cfg.padded_heads[1],
                           causal=True, window=cfg.local_window, q_chunk=cfg.q_chunk,
                           heads=heads)
    return Lyr.row_parallel(o.reshape(B, S, -1), lp["wo"], mesh), k, v


def _attn_decode(cfg, lp, h, kc, vc, pos: int, head_mask, mesh=None):
    """One step of windowed attention: k/v written in place at slot pos % W
    of the ring (kc, vc: (B, W, KVp, dh)); a slot holding position kpos is
    attended when 0 <= kpos and kpos > pos - W.  On a mesh every rank holds
    and writes the whole ring and attends with its q heads; the output is
    summed over ``"model"``."""
    B = h.shape[0]
    Gp = cfg.padded_heads[1]
    dh = cfg.head_dim
    W = kc.shape[1]
    q, k, v = _qkv(cfg, lp, h, torch.full((1,), pos, dtype=torch.int64, device=h.device))
    slot = pos % W
    kc[:, slot] = k[:, 0]
    vc[:, slot] = v[:, 0]
    kpos = pos - (slot - torch.arange(W, device=h.device)) % W  # age 0 = newest
    valid = (kpos >= 0) & (kpos > pos - W)
    heads = _block(mesh, cfg.n_heads_padded)
    ke = kc.repeat_interleave(Gp, dim=2)[:, :, heads].float()
    ve = vc.repeat_interleave(Gp, dim=2)[:, :, heads].float()
    s = torch.einsum("bhd,bthd->bht", q[:, 0].float() * dh ** -0.5, ke)
    s = s.masked_fill(~valid[None, None, :], Lyr.NEG)
    o = torch.einsum("bht,bthd->bhd", torch.softmax(s, dim=-1), ve).to(h.dtype)
    o = o * head_mask[heads].to(h.dtype)[None, :, None]
    return Lyr.row_parallel(o.reshape(B, -1), lp["wo"], mesh)


def _ring(k, W: int):
    """Prefill's last W keys (B, S, KVp, dh) at their ring slots: rolled by
    S % W when S >= W, else zero-padded to W."""
    S = k.shape[1]
    if S >= W:
        return torch.roll(k[:, -W:], shifts=S % W, dims=1)
    return F.pad(k, (0, 0, 0, 0, 0, W - S))


def _layers(cfg: ModelConfig, params, cache, mesh=None):
    """(kind, layer params, layer cache) for every layer in order: a
    segment's repeats, each running the pattern; on a mesh with each
    weight's ``"data"`` blocks gathered."""
    for (pat, reps), seg_p, seg_c in zip(segments(cfg), params["segments"],
                                         cache["segments"]):
        for r in range(reps):
            for kind, pp, cc in zip(pat, seg_p, seg_c):
                yield (kind, _gathered(_entries(cfg, kind), {k: t[r] for k, t in pp.items()},
                                       mesh),
                       {k: t[r] for k, t in cc.items()})


def _mlp(cfg, lp, x, mesh=None):
    """The block's second half: x plus the SwiGLU MLP of its norm."""
    return x + Lyr.swiglu(Lyr.rmsnorm(x, lp["ln2"], cfg.norm_eps), lp["wi"], lp["wg"],
                          lp["wod"], mesh)


# --------------------------------------------------------------------------
# public model functions
# --------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, batch: dict, max_seq: int | None = None,
            stats: dict | None = None, mesh=None, dp=MESH_DP):
    """Prompt ``batch["tokens"]`` (B, S) -> (last-token logits (B, Vp)
    float32 with the vocab mask, the cache after S tokens).  ``max_seq`` and
    ``stats`` are accepted for the uniform interface and unused.  On a
    ``mesh`` (module docstring): this rank's shards of the weights, the
    global batch in, the data shard's logits and cache shard out."""
    tokens = batch["tokens"]
    dev = tokens.device
    cache = alloc_cache(cfg, tokens.shape[0], 0, dev, mesh, dp)
    tokens = _rows(mesh, tokens, dp)
    S = tokens.shape[1]
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    head_mask, vocab_mask = _masks(cfg, dev)
    x = _embed_tokens(top, tokens, mesh)
    positions = torch.arange(S, device=dev)
    for kind, lp, c in _layers(cfg, params, cache, mesh):
        h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if kind == "rglru":
            o, conv, lru = _rglru_block(cfg, lp, h, c["conv"], mesh=mesh)
            c["conv"].copy_(conv)
            c["lru"].copy_(lru)
        else:
            o, k, v = _attn_block_full(cfg, lp, h, positions, head_mask, mesh)
            c["k"].copy_(_ring(k, cfg.local_window))
            c["v"].copy_(_ring(v, cfg.local_window))
        x = _mlp(cfg, lp, x + o, mesh)
    x = Lyr.rmsnorm(x[:, -1:], top["ln_f"], cfg.norm_eps)
    cache["length"] = S
    return _logits(cfg, top, x, vocab_mask, mesh)[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache: dict, token, stats: dict | None = None,
                mesh=None, dp=MESH_DP):
    """One step: token (B,) at position ``pos = cache["length"]`` -> (logits
    (B, Vp) float32, the cache advanced in place).  On a ``mesh``: the
    global batch's tokens in, the data shard's logits out."""
    pos = cache["length"]
    token = _rows(mesh, token, dp)
    rows = next(iter(cache["segments"][0][0].values())).shape[1]  # (reps, B, ...)
    if rows != token.shape[0]:
        raise ValueError(f"the cache holds {rows} rows, the token's shard {token.shape[0]}")
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    head_mask, vocab_mask = _masks(cfg, token.device)
    x = _embed_tokens(top, token, mesh)[:, None, :]    # (B, 1, D)
    for kind, lp, c in _layers(cfg, params, cache, mesh):
        h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if kind == "rglru":
            o, conv, lru = _rglru_block(cfg, lp, h, c["conv"], c["lru"], mesh)
            c["conv"].copy_(conv)
            c["lru"].copy_(lru)
        else:
            o = _attn_decode(cfg, lp, h, c["k"], c["v"], pos, head_mask, mesh)[:, None, :]
        x = _mlp(cfg, lp, x + o, mesh)
    x = Lyr.rmsnorm(x, top["ln_f"], cfg.norm_eps)
    cache["length"] = pos + 1
    return _logits(cfg, top, x, vocab_mask, mesh)[:, 0], cache


def train_loss(cfg: ModelConfig, params, batch: dict, mesh=None, dp=MESH_DP):
    """The mean next-token cross entropy over ``batch["tokens"]`` and
    ``batch["labels"]`` (B, S) (JAX's ``train_loss`` through ``_forward``):
    zero conv inputs and LRU state, every position kept, each repeat of a
    segment's pattern rematerialised.  On a ``mesh``, the transformer's
    contract (``transformer.train_loss``): the global batch in, split over
    every data axis of more than one rank, a repeat's ``"data"`` blocks
    gathered inside its rematerialised body, the conv inputs the rank's
    d_rnn block, the global mean out, the cross entropy
    vocabulary-parallel."""
    batch = _train_rows(mesh, batch, dp)
    tokens = batch["tokens"]
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    dev = tokens.device
    B, S = tokens.shape
    head_mask, vocab_mask = _masks(cfg, dev)
    x = _embed_tokens(top, tokens, mesh)
    positions = torch.arange(S, device=dev)
    R = _d_rnn(cfg)
    conv0 = torch.zeros((B, CONV_WIDTH - 1, len(range(R)[_block(mesh, R)])), dtype=x.dtype,
                        device=dev)

    def body(x, pat, lps):
        for kind, lp in zip(pat, lps):
            lp = _gathered(_entries(cfg, kind), lp, mesh)
            h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            if kind == "rglru":
                o = _rglru_block(cfg, lp, h, conv0, mesh=mesh)[0]
            else:
                o = _attn_block_full(cfg, lp, h, positions, head_mask, mesh)[0]
            x = _mlp(cfg, lp, x + o, mesh)
        return x

    body = make_remat(cfg, body)
    for (pat, reps), seg_p in zip(segments(cfg), params["segments"]):
        per_kind = [layer_slices(pp, reps) for pp in seg_p]
        for r in range(reps):
            x = body(x, pat, [lps[r] for lps in per_kind])
    x = Lyr.rmsnorm(x, top["ln_f"], cfg.norm_eps)
    return _ce_loss(_logits(cfg, top, x, vocab_mask, mesh, gather=False), batch["labels"],
                    mesh, dp)
