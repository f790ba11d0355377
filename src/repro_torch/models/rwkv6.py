"""RWKV-6 "Finch" of the port (``repro.models.rwkv6``): an attention-free
linear RNN with data-dependent decay, for serving and training.

Per head a matrix state ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` with the
bonus ``u``: ``y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)``; token shift
carries the last normed input of each block between calls.

Parameters: ``{"top": {embed, ln_f, head}, "layers": {name: (L, ...)}}``,
the JAX package's tree.  Every entry is bf16 but ``F32_ENTRIES`` (the decay
offset ``w0``, the bonus ``u`` and the per-head groupnorm's ``ln_x`` and
``ln_x_b``), which JAX uses as fp32 masters with no cast; for training
every entry is a float32 master (``masters=True``), cast at its use.

The WKV runs step by step, as JAX's inner scan does: r, k and v are bf16
matmul outputs upcast to f32, the decay w is f32 throughout, the state is
f32.  JAX's two-level chunked scan and its pad with w = 1 exist for
rematerialisation and leave the result as it is; here the steps run in
chunks of ``CHUNK`` only so that the outer products k v^T of a chunk are
formed in one call.  The step loop reads nothing back to the host.

The cache is ``{"s": (L, B, H, dh, dh) f32, "xt", "xc": (L, B, D) bf16,
"length"}``, independent of ``max_seq``; ``decode_step`` writes it in place.
``train_loss`` runs every layer from a zero state over the whole sequence,
keeps every position and writes nothing in place; each layer is
rematerialised (JAX's ``_stack``), so the backward pass holds one layer's
WKV states at a time.

**On a device mesh** (``mesh=``, a ``launch.mesh.RankMesh``), every rank
calls ``init``/``params_from_jax``, ``alloc_cache``, ``prefill``,
``decode_step`` and ``train_loss`` with the same arguments and holds its
shards by ``param_specs`` and ``cache_specs`` (JAX's ``abstract_init`` and
``abstract_cache``); a weight's ``"data"`` blocks are gathered at its use
(``base.wcast``):

* the residual stream is whole on every ``"model"`` rank, and the batch
  split over ``dp`` (``base.batch_axes``; ``dp=None`` keeps it whole);
* the time mix is head-parallel: ``w_r``, ``w_k``, ``w_v``, ``w_g`` and
  ``w_B`` are column-parallel over D (this rank's ``H / model`` heads),
  ``w0`` and ``u`` are the rank's heads, ``w_A`` is whole, so the WKV
  recurrence and the per-head groupnorm (the rank's block of ``ln_x`` and
  ``ln_x_b``) run on the rank's heads with no collective, and ``w_o`` is
  row-parallel (``layers.row_parallel``: a float32 sum over ``"model"``);
* the channel mix: ``wc_k`` column-parallel over d_ff, ``wc_v``
  row-parallel, ``wc_r`` column-parallel over D.  The rank's block of
  ``rr`` is **gathered** over ``"model"`` (bf16, exact) and multiplies the
  whole row-parallel sum, so the block's output comes out whole on every
  rank with no further collective;
* the state ``s`` holds the rank's heads; the token-shift carries ``xt``
  and ``xc`` hold the rank's D block of the normed stream's last token.
  A block needs the whole previous token, so each carry is **gathered**
  over ``"model"`` where the block reads it, and the rank's block of the
  new last token is stored;
* ``train_loss`` (FSDP over the data axes, tensor parallel over
  ``"model"``, as JAX's jitted step) keeps the transformer's contract: the
  global batch in, a layer's weights gathered inside its rematerialised
  body, the global mean out, the cross entropy vocabulary-parallel.  Its
  carries are zeros, whole on every rank, and gathered nowhere.  For the
  gradient, each tensor whole on every ``"model"`` rank that feeds the
  rank's block has its gradient summed over ``"model"``
  (``base._model_grad_sum``): the mixed inputs of ``w_r``, ``w_k``,
  ``w_v``, ``w_g``, ``wc_k`` and ``wc_r`` (so ``mu_*`` gets the whole
  gradient), ``tanh(zw @ w_A)`` before ``w_B``, and ``ln_x``/``ln_x_b``
  before the rank takes its block of them; ``rr``'s gather hands each
  rank its block of the gradient.

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
    _embed_tokens,
    _gathered,
    _logits,
    _model_gather,
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
from repro_torch.models.base import _block as _model_block
from repro_torch.models.transformer import _ce_loss, _masks

W_LORA = 64
CHUNK = 64
F32_ENTRIES = frozenset({"w0", "u", "ln_x", "ln_x_b"})


def _layer_entries(cfg: ModelConfig) -> dict:
    D, F_, dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    H = D // dh
    col, row = ("data", "model"), ("model", "data")
    return {
        "ln1": ((D,), "ones", None), "ln2": ((D,), "ones", None),
        # token-shift mixing coefficients for r, k, v, w, g and channel mix
        "mu_r": ((D,), "zeros", None), "mu_k": ((D,), "zeros", None),
        "mu_v": ((D,), "zeros", None), "mu_w": ((D,), "zeros", None),
        "mu_g": ((D,), "zeros", None), "mu_c": ((D,), "zeros", None),
        "w_r": ((D, D), "dense", col), "w_k": ((D, D), "dense", col),
        "w_v": ((D, D), "dense", col), "w_g": ((D, D), "dense", col),
        "w_o": ((D, D), "dense", row),
        # data-dependent decay lora: w = exp(-exp(w0 + tanh(z A) B))
        "w0": ((D,), "zeros", ("model",)),
        "w_A": ((D, W_LORA), "dense", ("data", None)),
        "w_B": ((W_LORA, D), "dense", (None, "model")),
        "u": ((H, dh), "zeros", ("model", None)),
        "ln_x": ((D,), "ones", None), "ln_x_b": ((D,), "zeros", None),
        # channel mix
        "wc_k": ((D, F_), "dense", col), "wc_v": ((F_, D), "dense", row),
        "wc_r": ((D, D), "dense", col),
    }


def _top_entries(cfg: ModelConfig) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    return {"embed": ((Vp, D), "dense", ("model", "data")), "ln_f": ((D,), "ones", None),
            "head": ((D, Vp), "dense", ("data", "model"))}


def param_shapes(cfg: ModelConfig) -> dict:
    """JAX's ``abstract_init`` tree, no allocation."""
    L = cfg.n_layers
    return {"top": {k: s for k, (s, _, _) in _top_entries(cfg).items()},
            "layers": {k: (L,) + s for k, (s, _, _) in _layer_entries(cfg).items()}}


def param_specs(cfg: ModelConfig) -> dict:
    """JAX's ``param_specs`` tree, one entry a dimension (``full_spec``)."""
    return {"top": {k: full_spec(sp, len(s)) for k, (s, _, sp) in _top_entries(cfg).items()},
            "layers": {k: full_spec(sp, len(s), stacked=True)
                       for k, (s, _, sp) in _layer_entries(cfg).items()}}


def init(cfg: ModelConfig, seed: int = 0, device="cuda", masters: bool = False,
         mesh=None) -> dict:
    """Seeded random weights on ``device`` (bf16, ``F32_ENTRIES`` float32;
    every entry float32 with ``masters``).  On a ``mesh``, this rank's
    shards (``base.shard``) of the same weights: each entry is drawn whole,
    in the same order, and cut at once."""
    pf = ParamFactory(seed, device, F32_ENTRIES, masters)
    L = cfg.n_layers
    return {"top": {k: pf.draw(k, s, kind, sp, mesh)
                    for k, (s, kind, sp) in _top_entries(cfg).items()},
            "layers": {k: pf.draw(k, (L,) + s, kind, sp, mesh, stacked=True)
                       for k, (s, kind, sp) in _layer_entries(cfg).items()}}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The state's tensors as (shape, dtype, sharding), JAX's
    ``abstract_cache`` template (``"data"`` for the batch axis); ``max_seq``
    is unused: the state does not grow with the sequence."""
    D, dh, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    H = D // dh
    return {"s": ((L, batch, H, dh, dh), torch.float32, (None, "data", "model", None, None)),
            "xt": ((L, batch, D), torch.bfloat16, (None, "data", "model")),
            "xc": ((L, batch, D), torch.bfloat16, (None, "data", "model"))}


def alloc_cache(cfg: ModelConfig, batch: int, max_seq: int, device, mesh=None,
                dp=MESH_DP) -> dict:
    """Zeroed state of :func:`cache_specs`'s tensors (what JAX's prefill
    starts from).  On a ``mesh``, this rank's shards of the state of the
    global ``batch`` (the batch over the axes ``dp``, the heads and the
    carries' D over ``"model"``)."""
    specs = cache_specs(cfg, batch, max_seq)
    if mesh is not None:
        _split(mesh, batch, dp=dp)
        _model_block(mesh, cfg.d_model // cfg.head_dim)  # whole heads a rank
        specs = rank_specs(specs, mesh, dp)
    return {**zeros_of(specs, device), "length": 0}


# --------------------------------------------------------------------------
# the WKV6 recurrence
# --------------------------------------------------------------------------


def wkv(r, k, v, w, u, state):
    """r, k, v (B, S, H, dh) bf16, w (B, S, H, dh) f32, u (H, dh) f32, state
    (B, H, dh, dh) f32 -> (y (B, S, H, dh) f32, the state after step S).

    Each step is JAX's ``_wkv_step``: ``att = S + u k v^T``, ``y = Σ_i
    att[i, :] r[i]`` and ``S = w S + k v^T``, the output read before the
    update."""
    uu = u[None, None, :, :, None]
    ys = []
    # one split of the sequence and one unbind a chunk: under autograd each
    # chunk's (each step's) slice then adds its gradient into one
    # concatenation (stack), not into a zeroed copy of the whole sequence
    # (chunk), so the backward's work stays linear in S
    chunks = zip(*(t.split(CHUNK, dim=1) for t in (r, k, v, w)))
    for rc, kc, vc, wc in chunks:
        rf, kf, vf = rc.float(), kc.float(), vc.float()
        kv = kf[..., :, None] * vf[..., None, :]          # (B, c, H, dh, dh)
        steps = zip(kv.unbind(1), (uu * kv).unbind(1), rf.unbind(1), wc.unbind(1))
        for kv_t, ukv_t, r_t, w_t in steps:
            att = state + ukv_t
            ys.append(torch.sum(att * r_t[:, :, :, None], dim=-2))
            state = w_t[:, :, :, None] * state + kv_t
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


def _time_mix(cfg, lp, x, state, x_prev, mesh=None):
    """x: (B, S, D) normed input -> (out, state, x's last token).  On a
    mesh the state, the WKV and the groupnorm are the rank's heads and the
    output is summed over ``"model"`` (module docstring); the mixed inputs
    of the column-parallel products, whole on every rank, have their
    gradients summed over ``"model"``."""
    B, S, D = x.shape
    dh = cfg.head_dim
    blk = _model_block(mesh, D)
    xx = _shift(x, x_prev)
    bf = x.dtype
    mixed = lambda mu: _model_grad_sum(_mix(x, xx, lp[mu]), mesh)  # noqa: E731
    r = mixed("mu_r") @ lp["w_r"].to(bf)
    k = mixed("mu_k") @ lp["w_k"].to(bf)
    v = mixed("mu_v") @ lp["w_v"].to(bf)
    g = F.silu(mixed("mu_g") @ lp["w_g"].to(bf))
    zw = _mix(x, xx, lp["mu_w"])
    lora = _model_grad_sum(torch.tanh(zw @ lp["w_A"].to(bf)), mesh)  # w_A is whole
    w_lora = lora @ lp["w_B"].to(bf)
    w = torch.exp(-torch.exp(torch.clamp(lp["w0"].float() + w_lora.float(), -8.0, 4.0)))
    hs = lambda t: t.reshape(B, S, -1, dh)  # noqa: E731  (this rank's heads)
    y, state = wkv(hs(r), hs(k), hs(v), hs(w), lp["u"].float(), state)
    # ln_x and ln_x_b are whole on every rank, which uses its block of them
    y = _head_groupnorm(y, _model_grad_sum(lp["ln_x"], mesh)[blk],
                        _model_grad_sum(lp["ln_x_b"], mesh)[blk]).to(bf) * g
    return Lyr.row_parallel(y, lp["w_o"], mesh), state, x[:, -1]


def _channel_mix(lp, x, x_prev, mesh=None):
    xx = _shift(x, x_prev)
    bf = x.dtype
    z = _model_grad_sum(_mix(x, xx, lp["mu_c"]), mesh)  # feeds wc_k's and wc_r's blocks
    kk = torch.square(F.relu(z @ lp["wc_k"].to(bf)))
    rr = _model_gather(torch.sigmoid(z @ lp["wc_r"].to(bf)), -1, mesh)
    return rr * Lyr.row_parallel(kk, lp["wc_v"], mesh), x[:, -1]


def _layer(cfg: ModelConfig, lp, x, s, xt, xc, mesh=None):
    """One layer over x (B, S, D) bf16 from the state ``s`` and the whole
    token-shift carries ``xt``, ``xc`` (B, D) -> (x, s, the normed
    streams' last tokens, whole)."""
    h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    o, s, xt = _time_mix(cfg, lp, h, s, xt, mesh)
    x = x + o
    o2, xc = _channel_mix(lp, Lyr.rmsnorm(x, lp["ln2"], cfg.norm_eps), xc, mesh)
    return x + o2, s, xt, xc


def _block(cfg: ModelConfig, lp, x, s, xt, xc, mesh=None):
    """One layer over x (B, S, D) bf16 from the carried state (s, xt, xc)
    -> (x, s, xt, xc) after the last token.  On a mesh the carries in and
    out are the rank's D block, gathered here for the token shift."""
    blk = _model_block(mesh, x.shape[-1])
    x, s, xt, xc = _layer(cfg, lp, x, s, _model_gather(xt, -1, mesh),
                          _model_gather(xc, -1, mesh), mesh)
    return x, s, xt[:, blk], xc[:, blk]


def _run(cfg: ModelConfig, params, x, cache, mesh=None):
    """Every block over x (B, S, D) bf16 from the cache's state, which is
    overwritten with the state after the last token; returns the final
    normed last position (B, 1, D)."""
    layers = params["layers"]
    entries = _layer_entries(cfg)
    for i in range(cfg.n_layers):
        lp = _gathered(entries, {k: t[i] for k, t in layers.items()}, mesh)
        x, s, xt, xc = _block(cfg, lp, x, cache["s"][i], cache["xt"][i], cache["xc"][i],
                              mesh)
        cache["s"][i] = s
        cache["xt"][i] = xt
        cache["xc"][i] = xc
    return Lyr.rmsnorm(x[:, -1:], params["top"]["ln_f"], cfg.norm_eps)


# --------------------------------------------------------------------------
# public model functions
# --------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, batch: dict, max_seq: int | None = None,
            stats: dict | None = None, mesh=None, dp=MESH_DP):
    """Prompt ``batch["tokens"]`` (B, S) -> (last-token logits (B, Vp)
    float32 with the vocab mask, the state after S tokens).  ``max_seq`` and
    ``stats`` are accepted for the uniform interface and unused.  On a
    ``mesh`` (module docstring): this rank's shards of the weights, the
    global batch in, the data shard's logits and state shard out."""
    tokens = batch["tokens"]
    cache = alloc_cache(cfg, tokens.shape[0], 0, tokens.device, mesh, dp)
    tokens = _rows(mesh, tokens, dp)
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    x = _embed_tokens(top, tokens, mesh)
    x = _run(cfg, params, x, cache, mesh)
    cache["length"] = tokens.shape[1]
    return _logits(cfg, top, x, _masks(cfg, tokens.device)[1], mesh)[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache: dict, token, stats: dict | None = None,
                mesh=None, dp=MESH_DP):
    """One O(1) step: token (B,) at position ``cache["length"]`` -> (logits
    (B, Vp) float32, the cache advanced in place).  On a ``mesh``: the
    global batch's tokens in, the data shard's logits out."""
    token = _rows(mesh, token, dp)
    if cache["s"].shape[1] != token.shape[0]:
        raise ValueError(f"the state holds {cache['s'].shape[1]} rows, the token's shard "
                         f"{token.shape[0]}")
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    x = _embed_tokens(top, token, mesh)[:, None, :]
    x = _run(cfg, params, x, cache, mesh)
    cache["length"] += 1
    return _logits(cfg, top, x, _masks(cfg, token.device)[1], mesh)[:, 0], cache


def train_loss(cfg: ModelConfig, params, batch: dict, mesh=None, dp=MESH_DP):
    """The mean next-token cross entropy over ``batch["tokens"]`` and
    ``batch["labels"]`` (B, S) (JAX's ``train_loss``): every layer from a
    zero state and zero token-shift carries, every position kept, each
    layer rematerialised (JAX's ``_stack``).

    On a ``mesh``, the transformer's contract (``transformer.train_loss``):
    every rank passes the global batch and its shards of the masters, runs
    its data shard's rows (split over every data axis of more than one
    rank), gathers a layer's ``"data"`` blocks inside the rematerialised
    body and returns the global batch's mean; the state holds the rank's
    heads and the zero carries are whole on every rank, so nothing gathers
    them; the loss is vocabulary-parallel."""
    batch = _train_rows(mesh, batch, dp)
    tokens = batch["tokens"]
    top = _gathered(_top_entries(cfg), params["top"], mesh)
    x = _embed_tokens(top, tokens, mesh)
    B, _, D = x.shape
    dh = cfg.head_dim
    heads = _model_block(mesh, D // dh)  # this rank's heads
    s0 = torch.zeros((B, len(range(D // dh)[heads]), dh, dh), dtype=torch.float32,
                     device=x.device)
    z = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    entries = _layer_entries(cfg)
    body = make_remat(cfg, lambda x, lp: _layer(cfg, _gathered(entries, lp, mesh), x, s0, z, z,
                                                mesh)[0])
    for lp in layer_slices(params["layers"], cfg.n_layers):
        x = body(x, lp)
    x = Lyr.rmsnorm(x, top["ln_f"], cfg.norm_eps)
    return _ce_loss(_logits(cfg, top, x, _masks(cfg, tokens.device)[1], mesh, gather=False),
                    batch["labels"], mesh, dp)
