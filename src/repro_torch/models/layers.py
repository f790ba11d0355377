"""Neural building blocks of the port's LM stack (``repro.models.layers``):
norms, RoPE, GQA attention (q-chunked over a full sequence, and one decode
step against a preallocated cache), SwiGLU and GELU MLPs, capacity-based
MoE dispatch.

Plain PyTorch, as the JAX package computes these in plain ``jnp`` outside
any Pallas kernel.  The arithmetic follows JAX's: statistics, RoPE angles,
attention scores and softmax in float32 from upcast inputs, the casts back
to the activation dtype where JAX has them (``bf16 * f32`` promotes to f32
in both frameworks when both operands are tensors with dimensions).  No
library attention kernel is used: it would change the arithmetic.

Shapes: B=batch, S=seq, T=keys, H=KVp*Gp padded q heads, KVp padded kv
heads, dh=head dim, D=d_model, F=d_ff, E=experts.  On one card the JAX
package's ``model`` axis has size 1, so its ``shard_map``/``pmax``/``psum``
are the identity and drop out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30  # masked score: exp(NEG - max) is exactly 0 in float32


def rmsnorm(x, scale, eps=1e-6):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # jnp.var: population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def rope(x, positions, theta=1e4):
    """Half-split (NeoX) rotation.  x: (..., S, heads..., dh); positions:
    (..., S) integers.  Angles in float32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(device=x.device, dtype=torch.float32) * freqs
    for _ in range(x.dim() - ang.dim() - 1):  # broadcast over head dims
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# attention: full sequence (prefill), q-chunked
# --------------------------------------------------------------------------


def attention_full(q, k, v, head_mask, *, group_size, causal=True, window=0,
                   q_chunk=512):
    """GQA attention over a full sequence.

    q: (B, S, H, dh); k, v: (B, T, KVp, dh); head_mask: (H,) zeros the
    padded heads.  KV heads are expanded with ``repeat_interleave`` (JAX's
    ``jnp.repeat``: q head h reads kv head h // group_size).  Queries go in
    chunks of ``q_chunk`` (a ragged tail is padded, then sliced off), so the
    live score tensor is (B, H, c, T) as in JAX's scan.
    """
    B, S, H, dh = q.shape
    T = k.shape[1]
    c = min(q_chunk, S)
    s_pad = -S % c
    if s_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad))
    scale = dh ** -0.5
    kf = k.repeat_interleave(group_size, dim=2).float()  # (B, T, H, dh)
    vf = v.repeat_interleave(group_size, dim=2).float()
    kpos = torch.arange(T, device=q.device)
    hm = head_mask.to(device=q.device, dtype=torch.float32)[None, None, :, None]
    out = []
    for c0 in range(0, S + s_pad, c):
        qb = q[:, c0 : c0 + c]
        qpos = c0 + torch.arange(c, device=q.device)
        s = torch.einsum("bchd,bthd->bhct", qb.float() * scale, kf)
        mask = torch.ones((c, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
        s = s.masked_fill(~mask[None, None], NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhct,bthd->bchd", p, vf) * hm
        out.append(o.to(q.dtype))
    return torch.cat(out, dim=1)[:, :S]


# --------------------------------------------------------------------------
# attention: one decode step against the cache
# --------------------------------------------------------------------------


def quantize_kv(x, dim=-1):
    """int8 along ``dim`` with one float32 scale a slice (``torch.round``
    rounds half to even, as ``jnp.round`` does)."""
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=dim) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale.unsqueeze(dim)), -127, 127)
    return q.to(torch.int8), scale


def flash_decode(q, k_cache, v_cache, k_new, v_new, pos: int, head_mask,
                 group_size, k_scale=None, v_scale=None, write=True):
    """One decode step against a preallocated cache, on one card.

    q: (B, H, dh); k_cache/v_cache: (B, Smax, KVp, dh), written in place at
    ``pos`` with k_new/v_new (B, KVp, dh); keys at positions <= pos are
    attended.  With ``write=False`` the caches are read only (k_new and
    v_new are ignored): whisper's cross-attention over its encoder states.
    With k_scale/v_scale (B, Smax, KVp) the caches are int8 with
    per-(token, head) float32 scales and the new token is quantized before
    its write.  The JAX package splits Smax over the ``model`` axis and
    combines partial softmaxes with a max and two sums; with one shard that
    is one softmax, with the denominator clamped at 1e-30 as there.

    Returns the attention output (B, H, dh) in q's dtype.
    """
    scale = q.shape[-1] ** -0.5
    int8 = k_scale is not None
    if write and int8:
        k_new, ks_new = quantize_kv(k_new)
        v_new, vs_new = quantize_kv(v_new)
        k_scale[:, pos] = ks_new
        v_scale[:, pos] = vs_new
    if write:
        k_cache[:, pos] = k_new
        v_cache[:, pos] = v_new
    if int8:
        kd = k_cache.float() * k_scale[..., None]
        vd = v_cache.float() * v_scale[..., None]
    else:
        kd, vd = k_cache, v_cache
    ke = kd.repeat_interleave(group_size, dim=2).float()  # (B, Smax, H, dh)
    ve = vd.repeat_interleave(group_size, dim=2).float()
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    s = torch.einsum("bhd,bthd->bht", q.float() * scale, ke)
    s = s.masked_fill((kpos > pos)[None, None, :], NEG)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    den = torch.sum(p, dim=-1)
    num = torch.einsum("bht,bthd->bhd", p, ve)
    out = (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
    return out * head_mask.to(device=q.device, dtype=q.dtype)[None, :, None]


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def swiglu(x, wi, wg, wo):
    h = torch.einsum("bsd,df->bsf", x, wi.to(x.dtype))
    g = torch.einsum("bsd,df->bsf", x, wg.to(x.dtype))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * h, wo.to(x.dtype))


def gelu_mlp(x, wi, bi, wo, bo):
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = F.gelu(torch.einsum("bsd,df->bsf", x, wi.to(x.dtype)) + bi.to(x.dtype),
               approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, wo.to(x.dtype)) + bo.to(x.dtype)


# --------------------------------------------------------------------------
# MoE: capacity-factor scatter dispatch (all experts on this card)
# --------------------------------------------------------------------------


def moe_route(x, w_router, *, top_k, capacity_factor, n_experts):
    """Routing of ``_moe_local`` with every expert local: (top_e (N, k),
    top_p (N, k) float32 renormalised, keep (N*k,) bool, rank (N*k,), cap).

    ``lax.top_k`` breaks ties toward the lower index: a stable descending
    sort does too.  A slot's rank within its expert comes from a stable
    argsort and ``searchsorted`` (left), scattered back through the order;
    slots ranked at or past ``cap = int(max(1, cf * k * N / E))`` (Python
    floats, as in JAX) are dropped.
    """
    B, S, D = x.shape
    N = B * S
    xt = x.reshape(N, D)
    logits = torch.einsum("nd,de->ne", xt, w_router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(-1)
    cap = int(max(1, capacity_factor * top_k * N / n_experts))
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_experts + 1, device=x.device))
    rank_sorted = torch.arange(flat_e.numel(), device=x.device) - starts[sorted_e]
    rank = torch.empty_like(flat_e).scatter_(0, order, rank_sorted)
    return top_e, top_p, rank < cap, rank, cap


def moe_block(x, w_router, w_in, w_gate, w_out, *, top_k, capacity_factor,
              stats=None):
    """MoE layer with all E experts on this card (JAX's ``moe_block`` off a
    mesh, i.e. ``_moe_local`` with no expert offset).

    x: (B, S, D); w_router: (D, E); w_in/w_gate: (E, D, F); w_out: (E, F, D).
    Kept slots are scattered into a (E, cap, D) buffer in x's dtype
    (``index_put_`` with accumulate: a kept slot gets its one non-zero add,
    a dropped one adds zero), the experts run as batched products, and each
    token sums its kept slots weighted by its renormalised router
    probabilities.  With ``stats`` (a dict), the kept and routed slot counts
    are added to ``stats["kept"]`` and ``stats["slots"]`` on the device.
    """
    B, S, D = x.shape
    E = w_in.shape[0]
    N = B * S
    top_e, top_p, keep, rank, cap = moe_route(
        x, w_router, top_k=top_k, capacity_factor=capacity_factor, n_experts=E)
    flat_e = top_e.reshape(-1)
    safe_rank = torch.clamp(rank, max=cap - 1)
    xk = x.reshape(N, D).repeat_interleave(top_k, dim=0)        # (N*k, D)
    buf = torch.zeros((E, cap, D), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, safe_rank),
                   torch.where(keep[:, None], xk, torch.zeros((), dtype=x.dtype,
                                                              device=x.device)),
                   accumulate=True)
    h = torch.bmm(buf, w_in.to(x.dtype))
    g = torch.bmm(buf, w_gate.to(x.dtype))
    y = torch.bmm(F.silu(g) * h, w_out.to(x.dtype))                # (E, cap, D)
    gathered = y[flat_e, safe_rank]                                # (N*k, D)
    w = torch.where(keep, top_p.reshape(-1), 0.0).to(x.dtype)
    out = (gathered * w[:, None]).reshape(N, top_k, D).sum(dim=1)
    if stats is not None:
        stats["kept"] = stats.get("kept", 0) + keep.sum()
        stats["slots"] = stats.get("slots", 0) + keep.numel()
    return out.reshape(B, S, D)
