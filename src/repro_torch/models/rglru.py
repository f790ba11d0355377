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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as Lyr
from repro_torch.models.base import ModelConfig, ParamFactory, layer_slices, make_remat
from repro_torch.models.transformer import _ce_loss, _embed_tokens, _logits, _masks, _qkv

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
    e = {"ln1": ((D,), "ones"), "ln2": ((D,), "ones"),
         "wi": ((D, F_), "dense"), "wg": ((D, F_), "dense"), "wod": ((F_, D), "dense")}
    if kind == "rglru":
        e.update({
            "w_a": ((D, R), "dense"),       # gelu branch
            "w_b": ((D, R), "dense"),       # recurrent branch
            "w_out": ((R, D), "dense"),
            "conv": ((CONV_WIDTH, R), "zeros"),
            "lam": ((R,), "ones"),          # Λ
            "gate_r": ((R,), "zeros"),      # diagonal recurrence gate
            "gate_i": ((R,), "zeros"),      # diagonal input gate
        })
    else:  # local MQA attention
        KVp, Gp = cfg.padded_heads
        dh = cfg.head_dim
        e.update({"wq": ((D, KVp * Gp * dh), "dense"), "wk": ((D, KVp * dh), "dense"),
                  "wv": ((D, KVp * dh), "dense"), "wo": ((KVp * Gp * dh, D), "dense")})
    return e


def _top_entries(cfg: ModelConfig) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    return {"embed": ((Vp, D), "dense"), "ln_f": ((D,), "ones"), "head": ((D, Vp), "dense")}


def param_shapes(cfg: ModelConfig) -> dict:
    """JAX's ``abstract_init`` tree, no allocation."""
    return {"top": {k: s for k, (s, _) in _top_entries(cfg).items()},
            "segments": [[{k: (reps,) + s for k, (s, _) in _entries(cfg, kind).items()}
                          for kind in pat] for pat, reps in segments(cfg)]}


def init(cfg: ModelConfig, seed: int = 0, device="cuda", masters: bool = False) -> dict:
    """Seeded random weights on ``device`` (bf16, ``F32_ENTRIES`` float32;
    every entry float32 with ``masters``)."""
    pf = ParamFactory(seed, device, F32_ENTRIES, masters)
    return {"top": {k: pf.make(k, s, kind) for k, (s, kind) in _top_entries(cfg).items()},
            "segments": [[{k: pf.make(k, (reps,) + s, kind)
                           for k, (s, kind) in _entries(cfg, kind_).items()}
                          for kind_ in pat] for pat, reps in segments(cfg)]}


def alloc_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """Zeroed cache (JAX's ``abstract_cache`` shapes and dtypes); ``max_seq``
    is unused: the state is O(window + d_rnn)."""
    R, W, dh = _d_rnn(cfg), cfg.local_window, cfg.head_dim
    KVp, _ = cfg.padded_heads
    z = lambda shape, dt=torch.bfloat16: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    segs = []
    for pat, reps in segments(cfg):
        segs.append([
            {"conv": z((reps, batch, CONV_WIDTH - 1, R)),
             "lru": z((reps, batch, R), torch.float32)} if kind == "rglru" else
            {"k": z((reps, batch, W, KVp, dh)), "v": z((reps, batch, W, KVp, dh))}
            for kind in pat])
    return {"length": 0, "segments": segs}


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


def _rglru_block(cfg, lp, h, conv_state, lru_state=None):
    """h: (B, S, D) normed input -> (out (B, S, D), conv state, lru state)."""
    bf = h.dtype
    a_br = F.gelu(h @ lp["w_a"].to(bf), approximate="tanh")  # jax.nn.gelu's default
    b, conv_state = _causal_conv(h @ lp["w_b"].to(bf), lp["conv"], conv_state)
    bf32 = b.float()
    r = torch.sigmoid(bf32 * lp["gate_r"])
    i = torch.sigmoid(bf32 * lp["gate_i"])
    a = torch.exp(-LRU_C * _softplus(lp["lam"]) * r)            # (B, S, R) f32
    gated = torch.sqrt(torch.clamp(1.0 - a ** 2, min=1e-9)) * (i * bf32)
    hseq, lru_state = _rglru_scan(gated, a, lru_state)
    return (hseq.to(bf) * a_br) @ lp["w_out"].to(bf), conv_state, lru_state


# --------------------------------------------------------------------------
# local attention: the full sequence, and one step on the ring buffer
# --------------------------------------------------------------------------


def _attn_block_full(cfg, lp, h, positions, head_mask):
    """Windowed causal attention over h (B, S, D) -> (out, k, v)."""
    B, S, _ = h.shape
    q, k, v = _qkv(cfg, lp, h, positions)
    o = Lyr.attention_full(q, k, v, head_mask, group_size=cfg.padded_heads[1], causal=True,
                           window=cfg.local_window, q_chunk=cfg.q_chunk)
    return o.reshape(B, S, -1) @ lp["wo"].to(h.dtype), k, v


def _attn_decode(cfg, lp, h, kc, vc, pos: int, head_mask):
    """One step of windowed attention: k/v written in place at slot pos % W
    of the ring (kc, vc: (B, W, KVp, dh)); a slot holding position kpos is
    attended when 0 <= kpos and kpos > pos - W."""
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
    ke = kc.repeat_interleave(Gp, dim=2).float()
    ve = vc.repeat_interleave(Gp, dim=2).float()
    s = torch.einsum("bhd,bthd->bht", q[:, 0].float() * dh ** -0.5, ke)
    s = s.masked_fill(~valid[None, None, :], Lyr.NEG)
    o = torch.einsum("bht,bthd->bhd", torch.softmax(s, dim=-1), ve).to(h.dtype)
    o = o * head_mask.to(h.dtype)[None, :, None]
    return o.reshape(B, -1) @ lp["wo"].to(h.dtype)


def _ring(k, W: int):
    """Prefill's last W keys (B, S, KVp, dh) at their ring slots: rolled by
    S % W when S >= W, else zero-padded to W."""
    S = k.shape[1]
    if S >= W:
        return torch.roll(k[:, -W:], shifts=S % W, dims=1)
    return F.pad(k, (0, 0, 0, 0, 0, W - S))


def _layers(cfg: ModelConfig, params, cache):
    """(kind, layer params, layer cache) for every layer in order: a
    segment's repeats, each running the pattern."""
    for (pat, reps), seg_p, seg_c in zip(segments(cfg), params["segments"],
                                         cache["segments"]):
        for r in range(reps):
            for kind, pp, cc in zip(pat, seg_p, seg_c):
                yield (kind, {k: t[r] for k, t in pp.items()},
                       {k: t[r] for k, t in cc.items()})


# --------------------------------------------------------------------------
# public model functions
# --------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, batch: dict, max_seq: int | None = None,
            stats: dict | None = None):
    """Prompt ``batch["tokens"]`` (B, S) -> (last-token logits (B, Vp)
    float32 with the vocab mask, the cache after S tokens).  ``max_seq`` and
    ``stats`` are accepted for the uniform interface and unused."""
    tokens = batch["tokens"]
    top = params["top"]
    dev = tokens.device
    B, S = tokens.shape
    head_mask, vocab_mask = _masks(cfg, dev)
    x = _embed_tokens(top, tokens)
    positions = torch.arange(S, device=dev)
    cache = alloc_cache(cfg, B, 0, dev)
    for kind, lp, c in _layers(cfg, params, cache):
        h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if kind == "rglru":
            o, conv, lru = _rglru_block(cfg, lp, h, c["conv"])
            c["conv"].copy_(conv)
            c["lru"].copy_(lru)
        else:
            o, k, v = _attn_block_full(cfg, lp, h, positions, head_mask)
            c["k"].copy_(_ring(k, cfg.local_window))
            c["v"].copy_(_ring(v, cfg.local_window))
        x = x + o
        x = x + Lyr.swiglu(Lyr.rmsnorm(x, lp["ln2"], cfg.norm_eps), lp["wi"], lp["wg"],
                           lp["wod"])
    x = Lyr.rmsnorm(x[:, -1:], top["ln_f"], cfg.norm_eps)
    cache["length"] = S
    return _logits(cfg, top, x, vocab_mask)[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache: dict, token, stats: dict | None = None):
    """One step: token (B,) at position ``pos = cache["length"]`` -> (logits
    (B, Vp) float32, the cache advanced in place)."""
    pos = cache["length"]
    top = params["top"]
    head_mask, vocab_mask = _masks(cfg, token.device)
    x = _embed_tokens(top, token)[:, None, :]    # (B, 1, D)
    for kind, lp, c in _layers(cfg, params, cache):
        h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if kind == "rglru":
            o, conv, lru = _rglru_block(cfg, lp, h, c["conv"], c["lru"])
            c["conv"].copy_(conv)
            c["lru"].copy_(lru)
        else:
            o = _attn_decode(cfg, lp, h, c["k"], c["v"], pos, head_mask)[:, None, :]
        x = x + o
        x = x + Lyr.swiglu(Lyr.rmsnorm(x, lp["ln2"], cfg.norm_eps), lp["wi"], lp["wg"],
                           lp["wod"])
    x = Lyr.rmsnorm(x, top["ln_f"], cfg.norm_eps)
    cache["length"] = pos + 1
    return _logits(cfg, top, x, vocab_mask)[:, 0], cache


def train_loss(cfg: ModelConfig, params, batch: dict):
    """The mean next-token cross entropy over ``batch["tokens"]`` and
    ``batch["labels"]`` (B, S) (JAX's ``train_loss`` through ``_forward``):
    zero conv inputs and LRU state, every position kept, each repeat of a
    segment's pattern rematerialised."""
    tokens = batch["tokens"]
    top = params["top"]
    dev = tokens.device
    B, S = tokens.shape
    head_mask, vocab_mask = _masks(cfg, dev)
    x = _embed_tokens(top, tokens)
    positions = torch.arange(S, device=dev)
    conv0 = torch.zeros((B, CONV_WIDTH - 1, _d_rnn(cfg)), dtype=x.dtype, device=dev)

    def body(x, pat, lps):
        for kind, lp in zip(pat, lps):
            h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            if kind == "rglru":
                o = _rglru_block(cfg, lp, h, conv0)[0]
            else:
                o = _attn_block_full(cfg, lp, h, positions, head_mask)[0]
            x = x + o
            x = x + Lyr.swiglu(Lyr.rmsnorm(x, lp["ln2"], cfg.norm_eps), lp["wi"], lp["wg"],
                               lp["wod"])
        return x

    body = make_remat(cfg, body)
    for (pat, reps), seg_p in zip(segments(cfg), params["segments"]):
        per_kind = [layer_slices(pp, reps) for pp in seg_p]
        for r in range(reps):
            x = body(x, pat, [lps[r] for lps in per_kind])
    x = Lyr.rmsnorm(x, top["ln_f"], cfg.norm_eps)
    return _ce_loss(_logits(cfg, top, x, vocab_mask), batch["labels"])
