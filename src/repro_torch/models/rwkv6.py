"""RWKV-6 "Finch" of the port (``repro.models.rwkv6``): an attention-free
linear RNN with data-dependent decay, for serving.

Per head a matrix state ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` with the
bonus ``u``: ``y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)``; token shift
carries the last normed input of each block between calls.

Parameters: ``{"top": {embed, ln_f, head}, "layers": {name: (L, ...)}}``,
the JAX package's tree.  Every entry is bf16 but ``F32_ENTRIES`` (the decay
offset ``w0``, the bonus ``u`` and the per-head groupnorm's ``ln_x`` and
``ln_x_b``), which JAX uses as fp32 masters with no cast.

The WKV runs step by step, as JAX's inner scan does: r, k and v are bf16
matmul outputs upcast to f32, the decay w is f32 throughout, the state is
f32.  JAX's two-level chunked scan and its pad with w = 1 exist for
rematerialisation and leave the result as it is; here the steps run in
chunks of ``CHUNK`` only so that the outer products k v^T of a chunk are
formed in one call.  The step loop reads nothing back to the host.

The cache is ``{"s": (L, B, H, dh, dh) f32, "xt", "xc": (L, B, D) bf16,
"length"}``, independent of ``max_seq``; ``decode_step`` writes it in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as Lyr
from repro_torch.models.base import ModelConfig, ParamFactory
from repro_torch.models.transformer import _logits, _masks

W_LORA = 64
CHUNK = 64
F32_ENTRIES = frozenset({"w0", "u", "ln_x", "ln_x_b"})


def _layer_entries(cfg: ModelConfig) -> dict:
    D, F_, dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    H = D // dh
    return {
        "ln1": ((D,), "ones"), "ln2": ((D,), "ones"),
        # token-shift mixing coefficients for r, k, v, w, g and channel mix
        "mu_r": ((D,), "zeros"), "mu_k": ((D,), "zeros"), "mu_v": ((D,), "zeros"),
        "mu_w": ((D,), "zeros"), "mu_g": ((D,), "zeros"), "mu_c": ((D,), "zeros"),
        "w_r": ((D, D), "dense"), "w_k": ((D, D), "dense"), "w_v": ((D, D), "dense"),
        "w_g": ((D, D), "dense"), "w_o": ((D, D), "dense"),
        # data-dependent decay lora: w = exp(-exp(w0 + tanh(z A) B))
        "w0": ((D,), "zeros"),
        "w_A": ((D, W_LORA), "dense"),
        "w_B": ((W_LORA, D), "dense"),
        "u": ((H, dh), "zeros"),
        "ln_x": ((D,), "ones"), "ln_x_b": ((D,), "zeros"),
        # channel mix
        "wc_k": ((D, F_), "dense"), "wc_v": ((F_, D), "dense"), "wc_r": ((D, D), "dense"),
    }


def _top_entries(cfg: ModelConfig) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    return {"embed": ((Vp, D), "dense"), "ln_f": ((D,), "ones"), "head": ((D, Vp), "dense")}


def param_shapes(cfg: ModelConfig) -> dict:
    """JAX's ``abstract_init`` tree, no allocation."""
    L = cfg.n_layers
    return {"top": {k: s for k, (s, _) in _top_entries(cfg).items()},
            "layers": {k: (L,) + s for k, (s, _) in _layer_entries(cfg).items()}}


def init(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded random weights on ``device`` (bf16, ``F32_ENTRIES`` float32)."""
    pf = ParamFactory(seed, device, F32_ENTRIES)
    L = cfg.n_layers
    return {"top": {k: pf.make(k, s, kind) for k, (s, kind) in _top_entries(cfg).items()},
            "layers": {k: pf.make(k, (L,) + s, kind)
                       for k, (s, kind) in _layer_entries(cfg).items()}}


def alloc_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """Zeroed state (what JAX's prefill starts from); ``max_seq`` is unused:
    the state does not grow with the sequence."""
    D, dh, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    H = D // dh
    return {"s": torch.zeros((L, batch, H, dh, dh), dtype=torch.float32, device=device),
            "xt": torch.zeros((L, batch, D), dtype=torch.bfloat16, device=device),
            "xc": torch.zeros((L, batch, D), dtype=torch.bfloat16, device=device),
            "length": 0}


# --------------------------------------------------------------------------
# the WKV6 recurrence
# --------------------------------------------------------------------------


def wkv(r, k, v, w, u, state):
    """r, k, v (B, S, H, dh) bf16, w (B, S, H, dh) f32, u (H, dh) f32, state
    (B, H, dh, dh) f32 -> (y (B, S, H, dh) f32, the state after step S).

    Each step is JAX's ``_wkv_step``: ``att = S + u k v^T``, ``y = Σ_i
    att[i, :] r[i]`` and ``S = w S + k v^T``, the output read before the
    update."""
    S = r.shape[1]
    uu = u[None, None, :, :, None]
    ys = []
    for c0 in range(0, S, CHUNK):
        rf = r[:, c0 : c0 + CHUNK].float()
        kf = k[:, c0 : c0 + CHUNK].float()
        vf = v[:, c0 : c0 + CHUNK].float()
        kv = kf[..., :, None] * vf[..., None, :]          # (B, c, H, dh, dh)
        ukv = uu * kv
        for t in range(kv.shape[1]):
            att = state + ukv[:, t]
            ys.append(torch.sum(att * rf[:, t, :, :, None], dim=-2))
            state = w[:, c0 + t, :, :, None] * state + kv[:, t]
    return torch.stack(ys, dim=1), state


def _shift(x, prev):
    """Token shift: x_{t-1}, with the carried ``prev`` (B, D) at t = 0."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _head_groupnorm(y, scale, bias, eps=1e-5):
    """GroupNorm with one group a head over (B, S, H, dh) f32 y; f32 scale
    and bias, so the result stays f32 (JAX casts it to y's dtype)."""
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    yn = (y - mu) * torch.rsqrt(var + eps)
    B, S, H, dh = y.shape
    return yn.reshape(B, S, H * dh) * scale + bias


def _time_mix(cfg, lp, x, state, x_prev):
    """x: (B, S, D) normed input -> (out, state, x's last token)."""
    B, S, D = x.shape
    dh = cfg.head_dim
    H = D // dh
    xx = _shift(x, x_prev)
    r = _mix(x, xx, lp["mu_r"]) @ lp["w_r"]
    k = _mix(x, xx, lp["mu_k"]) @ lp["w_k"]
    v = _mix(x, xx, lp["mu_v"]) @ lp["w_v"]
    g = F.silu(_mix(x, xx, lp["mu_g"]) @ lp["w_g"])
    zw = _mix(x, xx, lp["mu_w"])
    w_lora = torch.tanh(zw @ lp["w_A"]) @ lp["w_B"]
    w = torch.exp(-torch.exp(torch.clamp(lp["w0"].float() + w_lora.float(), -8.0, 4.0)))
    hs = lambda t: t.reshape(B, S, H, dh)  # noqa: E731
    y, state = wkv(hs(r), hs(k), hs(v), hs(w), lp["u"].float(), state)
    y = _head_groupnorm(y, lp["ln_x"], lp["ln_x_b"]).to(x.dtype) * g
    return y @ lp["w_o"], state, x[:, -1]


def _channel_mix(lp, x, x_prev):
    xx = _shift(x, x_prev)
    z = _mix(x, xx, lp["mu_c"])
    kk = torch.square(F.relu(z @ lp["wc_k"]))
    rr = torch.sigmoid(z @ lp["wc_r"])
    return rr * (kk @ lp["wc_v"]), x[:, -1]


def _block(cfg: ModelConfig, lp, x, s, xt, xc):
    """One layer over x (B, S, D) bf16 from the carried state (s, xt, xc)
    -> (x, s, xt, xc) after the last token."""
    h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    o, s, xt = _time_mix(cfg, lp, h, s, xt)
    x = x + o
    o2, xc = _channel_mix(lp, Lyr.rmsnorm(x, lp["ln2"], cfg.norm_eps), xc)
    return x + o2, s, xt, xc


def _run(cfg: ModelConfig, params, x, cache):
    """Every block over x (B, S, D) bf16 from the cache's state, which is
    overwritten with the state after the last token; returns the final
    normed last position (B, 1, D)."""
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: t[i] for k, t in layers.items()}
        x, s, xt, xc = _block(cfg, lp, x, cache["s"][i], cache["xt"][i], cache["xc"][i])
        cache["s"][i] = s
        cache["xt"][i] = xt
        cache["xc"][i] = xc
    return Lyr.rmsnorm(x[:, -1:], params["top"]["ln_f"], cfg.norm_eps)


# --------------------------------------------------------------------------
# public model functions
# --------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, batch: dict, max_seq: int | None = None,
            stats: dict | None = None):
    """Prompt ``batch["tokens"]`` (B, S) -> (last-token logits (B, Vp)
    float32 with the vocab mask, the state after S tokens).  ``max_seq`` and
    ``stats`` are accepted for the uniform interface and unused."""
    tokens = batch["tokens"]
    top = params["top"]
    x = top["embed"][tokens]
    cache = alloc_cache(cfg, tokens.shape[0], 0, tokens.device)
    x = _run(cfg, params, x, cache)
    cache["length"] = tokens.shape[1]
    return _logits(cfg, top, x, _masks(cfg, tokens.device)[1])[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache: dict, token, stats: dict | None = None):
    """One O(1) step: token (B,) at position ``cache["length"]`` -> (logits
    (B, Vp) float32, the cache advanced in place)."""
    top = params["top"]
    x = top["embed"][token][:, None, :]
    x = _run(cfg, params, x, cache)
    cache["length"] += 1
    return _logits(cfg, top, x, _masks(cfg, token.device)[1])[:, 0], cache
