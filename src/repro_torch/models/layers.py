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
heads, dh=head dim, D=d_model, F=d_ff, E=experts.

On a device mesh (``launch.mesh.RankMesh``) each function is one rank's
part, with the collectives explicit where JAX's ``shard_map`` names them
(``flash_decode``'s ``pmax`` and two ``psum``s, ``moe_block``'s ``psum``)
and where XLA's partitioner puts them for a product whose contracted
dimension is split over ``"model"`` (:func:`row_parallel`).  Partial sums
cross the ranks in float32 and are rounded once to the activations'
dtype, as XLA on the CPU promotes a bf16 all-reduce to float32.  For a
gradient (training on a mesh), a tensor whole on every ``"model"`` rank
that feeds the rank's block of d_ff or of the experts has its gradient
summed over ``"model"`` (``base._model_grad_sum``), and a row-parallel
sum passes its gradient through.  With one rank on ``"model"`` no
collective runs and each function computes what it computes without a
mesh, to the bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import all_reduce_max, all_reduce_sum
from repro_torch.models.base import _model_grad_sum

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
                   q_chunk=512, heads=slice(None)):
    """GQA attention over a full sequence.

    q: (B, S, H, dh); k, v: (B, T, KVp, dh); head_mask: (H,) zeros the
    padded heads.  KV heads are expanded with ``repeat_interleave`` (JAX's
    ``jnp.repeat``: q head h reads kv head h // group_size).  Queries go in
    chunks of ``q_chunk`` (a ragged tail is padded, then sliced off), so the
    live score tensor is (B, H, c, T) as in JAX's scan.  ``heads``: the
    expanded heads that q and head_mask hold, a rank's block of the q heads
    when they are split over ``"model"`` (k and v are whole on every rank).
    """
    B, S, H, dh = q.shape
    T = k.shape[1]
    c = min(q_chunk, S)
    s_pad = -S % c
    if s_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad))
    scale = dh ** -0.5
    kf = k.repeat_interleave(group_size, dim=2)[:, :, heads].float()  # (B, T, H, dh)
    vf = v.repeat_interleave(group_size, dim=2)[:, :, heads].float()
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


def _model_group(mesh):
    """(the ``"model"`` process group or None, its size, this rank's index)."""
    if mesh is None:
        return None, 1, 0
    return mesh.group("model"), mesh.axis_size("model"), mesh.axis_index("model")


def flash_decode(q, k_cache, v_cache, k_new, v_new, pos: int, head_mask,
                 group_size, k_scale=None, v_scale=None, write=True, mesh=None):
    """One decode step against a preallocated cache (flash-decoding).

    q: (B, H, dh); k_cache/v_cache: (B, Smax, KVp, dh), written in place at
    ``pos`` with k_new/v_new (B, KVp, dh); keys at positions <= pos are
    attended.  With ``write=False`` the caches are read only (k_new and
    v_new are ignored): whisper's cross-attention over its encoder states.
    With k_scale/v_scale (B, Smax, KVp) the caches are int8 with
    per-(token, head) float32 scales and the new token is quantized before
    its write.

    On a ``mesh`` (JAX's ``shard_map`` over a cache split along Smax) the
    caches are this rank's block: ``s_loc = Smax / model`` slots, ``ax ·
    s_loc ... (ax+1) · s_loc - 1`` of every row of its data shard, ``ax``
    its ``"model"`` index; q, k_new and v_new are the shard's rows, whole
    on every ``"model"`` rank.  Only the rank that owns ``pos`` writes it.
    Each rank takes a partial softmax over its slots (max m, sum l, output
    o), and the partials combine in JAX's order: ``all_reduce(MAX)`` of m,
    then ``all_reduce(SUM)`` of ``o · α`` and of ``l · α`` with ``α = exp(m
    - max)``, the denominator clamped at 1e-30, ``head_mask`` last.  With
    one shard that is one softmax (α = 1 exactly) and no collective runs.

    Returns the attention output (B, H, dh) in q's dtype.  A write at
    ``pos`` past the cache's ``Smax`` slots raises ``ValueError`` on every
    rank, before any rank's cache changes: JAX's ``flash_decode`` drops
    that write and attends over the old cache.
    """
    group, n_model, ax = _model_group(mesh)
    s_loc = k_cache.shape[1]
    smax = s_loc * n_model
    if write and not 0 <= pos < smax:
        raise ValueError(f"decode position pos={pos} is outside the cache's "
                         f"{smax} slots; allocate a longer cache")
    scale = q.shape[-1] ** -0.5
    int8 = k_scale is not None
    off = pos - ax * s_loc
    if write and 0 <= off < s_loc:  # this rank owns slot pos
        if int8:
            k_new, ks_new = quantize_kv(k_new)
            v_new, vs_new = quantize_kv(v_new)
            k_scale[:, off] = ks_new
            v_scale[:, off] = vs_new
        k_cache[:, off] = k_new
        v_cache[:, off] = v_new
    if int8:
        kd = k_cache.float() * k_scale[..., None]
        vd = v_cache.float() * v_scale[..., None]
    else:
        kd, vd = k_cache, v_cache
    ke = kd.repeat_interleave(group_size, dim=2).float()  # (B, s_loc, H, dh)
    ve = vd.repeat_interleave(group_size, dim=2).float()
    kpos = ax * s_loc + torch.arange(s_loc, device=q.device)
    s = torch.einsum("bhd,bthd->bht", q.float() * scale, ke)
    s = s.masked_fill((kpos > pos)[None, None, :], NEG)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    den = torch.sum(p, dim=-1)
    num = torch.einsum("bht,bthd->bhd", p, ve)
    if n_model > 1:
        alpha = torch.exp(m - all_reduce_max(m.clone(), group))
        num = all_reduce_sum(num * alpha[..., None], group)
        den = all_reduce_sum(den * alpha, group)
    out = (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
    return out * head_mask.to(device=q.device, dtype=q.dtype)[None, :, None]


def row_parallel(a, w, mesh=None, eq=None):
    """``a @ w`` (or ``torch.einsum(eq, a, w)``) in a's dtype, where w's
    rows, the contracted dimension, are this rank's ``"model"`` block and
    a holds the same block of its last dimension (Megatron's row-parallel
    product).  The weight is cast to a's dtype first, as at every use (a
    float32 training master too).  On more than one ``"model"`` rank each
    rank's partial product of those values is formed in float32, summed
    over the group in float32 and rounded once to a's dtype; on one it is
    the product itself."""
    group, n_model, _ = _model_group(mesh)
    prod = (lambda x, y: x @ y) if eq is None else (lambda x, y: torch.einsum(eq, x, y))
    w = w.to(a.dtype)
    if n_model == 1:
        return prod(a, w)
    return all_reduce_sum(prod(a.float(), w.float()), group).to(a.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def swiglu(x, wi, wg, wo, mesh=None):
    """SwiGLU MLP; on a mesh wi/wg are this rank's ``"model"`` block of
    d_ff's columns and wo of its rows (column-, then row-parallel; x's
    gradient summed over ``"model"``)."""
    x = _model_grad_sum(x, mesh)
    h = torch.einsum("bsd,df->bsf", x, wi.to(x.dtype))
    g = torch.einsum("bsd,df->bsf", x, wg.to(x.dtype))
    return row_parallel(F.silu(g) * h, wo, mesh, "bsf,fd->bsd")


def gelu_mlp(x, wi, bi, wo, bo, mesh=None):
    """``jax.nn.gelu``'s default is the tanh approximation.  On a mesh wi
    and bi are this rank's ``"model"`` block of d_ff's columns and wo of
    its rows (column-, then row-parallel; x's gradient summed over
    ``"model"``); ``bo`` is added once, after the sum."""
    x = _model_grad_sum(x, mesh)
    h = F.gelu(torch.einsum("bsd,df->bsf", x, wi.to(x.dtype)) + bi.to(x.dtype),
               approximate="tanh")
    return row_parallel(h, wo, mesh, "bsf,fd->bsd") + bo.to(x.dtype)


# --------------------------------------------------------------------------
# MoE: capacity-factor scatter dispatch, experts split over "model"
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
              stats=None, mesh=None):
    """Expert-parallel MoE layer (JAX's ``moe_block``: ``_moe_local`` on
    each rank, then a ``psum`` over ``"model"``).

    x: (B, S, D), the tokens of this rank's data shard; w_router: (D, E),
    whole; w_in/w_gate: (E_loc, D, F) and w_out: (E_loc, F, D), this rank's
    experts ``ax · E_loc ... (ax+1) · E_loc - 1`` (all E off a mesh).
    Routing runs over all E experts from the router, with the capacity
    ``cap`` counted from the shard's own ``B·S`` tokens.  Kept slots of this
    rank's experts are scattered into a (E_loc, cap, D) buffer in x's dtype
    (``index_put_`` with accumulate: a kept slot gets its one non-zero add,
    a dropped or foreign one adds zero), the experts run as batched
    products, and each token sums its kept slots weighted by its
    renormalised router probabilities: a partial output (tokens routed
    elsewhere add zero), summed over ``"model"`` in float32 and rounded
    once to x's dtype.  For a gradient, the experts' input and the routing
    weights are summed over ``"model"`` in the backward: each rank's is a
    partial term, its own experts' share.  With ``stats`` (a dict),
    ``stats["kept"]`` adds the
    slots this rank's experts kept and ``stats["slots"]`` the shard's routed
    slots, on the device: a data shard's kept count is the sum of
    ``"kept"`` over its ``"model"`` group.
    """
    B, S, D = x.shape
    E, E_loc = w_router.shape[-1], w_in.shape[0]
    N = B * S
    group, n_model, ax = _model_group(mesh)
    top_e, top_p, keep, rank, cap = moe_route(
        x, w_router, top_k=top_k, capacity_factor=capacity_factor, n_experts=E)
    # a slot's rank within its expert is the same over all E experts as over
    # this rank's E_loc and the trash bucket of _moe_local: ranks order the
    # slots of one expert alone
    flat_e = top_e.reshape(-1) - ax * E_loc
    mine = (flat_e >= 0) & (flat_e < E_loc)
    keep = keep & mine
    flat_e = torch.where(mine, flat_e, 0)
    safe_rank = torch.clamp(rank, max=cap - 1)
    xk = _model_grad_sum(x, mesh).reshape(N, D).repeat_interleave(top_k, dim=0)  # (N*k, D)
    buf = torch.zeros((E_loc, cap, D), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, safe_rank),
                   torch.where(keep[:, None], xk, torch.zeros((), dtype=x.dtype,
                                                              device=x.device)),
                   accumulate=True)
    h = torch.bmm(buf, w_in.to(x.dtype))
    g = torch.bmm(buf, w_gate.to(x.dtype))
    y = torch.bmm(F.silu(g) * h, w_out.to(x.dtype))                # (E_loc, cap, D)
    gathered = y[flat_e, safe_rank]                                # (N*k, D)
    w = torch.where(keep, _model_grad_sum(top_p, mesh).reshape(-1), 0.0).to(x.dtype)
    out = (gathered * w[:, None]).reshape(N, top_k, D).sum(dim=1)
    if n_model > 1:
        out = all_reduce_sum(out.float(), group).to(x.dtype)
    if stats is not None:
        stats["kept"] = stats.get("kept", 0) + keep.sum()
        stats["slots"] = stats.get("slots", 0) + keep.numel()
    return out.reshape(B, S, D)
