"""Model configuration and parameter plumbing of the port's LM stack
(``repro.models.base``).

:class:`ModelConfig` carries every field of the JAX package's config, so
two configurations compare field by field.  The port runs on one card, but
it keeps the JAX package's padding for the 16-way tensor-parallel axis
(``model_axis``): q/kv heads padded to the minimal (KVp, Gp) with
KVp·Gp % model_axis == 0 that keeps the q→kv group mapping (the padded
slots are zeroed by :meth:`ModelConfig.head_mask`), and the vocabulary to
a multiple of 256 (the padded logits get -1e9 from
:meth:`ModelConfig.vocab_mask`).  So every parameter has JAX's shape and
weights carry across one for one (``models/weights.py``).

Fields that steer only XLA are kept so configurations compare, and are
inert here: ``scan_unroll`` (layers run in a Python loop), ``attn_impl``
(one card, no head sharding).  ``remat`` rematerialises each layer body of
``train_loss`` where JAX does (:func:`make_remat`); ``remat_policy`` is
inert (:func:`make_remat` says why); ``grad_dtype`` selects the training
step's bf16 compute copy (``train/loop.py``).

Weights are bf16 for serving (``init`` and ``params_from_jax`` cast once
at load) and float32 masters for training (``masters=True``, JAX's
storage): every module casts a weight to the activations' dtype at its
use, as JAX's ``wcast`` does, which is free for bf16 weights and carries
the gradient through the cast to an fp32 master.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

MODEL_AXIS_SIZE = 16  # the JAX package's production TP width; padding is for it


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"       # dense|moe|rwkv|hybrid|encdec|vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    qk_norm: bool = False
    qkv_bias: bool = False
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_interleave: int = 1     # 1 = every layer is MoE; 2 = every other
    capacity_factor: float = 1.25
    # hybrid (recurrentgemma): repeating block pattern
    pattern: tuple = ()
    local_window: int = 0       # >0: sliding-window attention
    d_rnn: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    # modality stub: frontend embeddings take seq // frontend_len_div slots
    frontend: str = "none"      # none | frames | patches
    frontend_len_div: int = 4
    tie_embeddings: bool = False
    # execution
    q_chunk: int = 512          # prefill score tensor bounded at (B, c, H, T)
    kv_cache_dtype: str = "bf16"  # bf16 | int8 (per-token-per-head scales)
    remat: bool = True          # rematerialise each layer body of train_loss
    remat_policy: str = "none"  # none | weights: the same on one card (make_remat)
    grad_dtype: str = "f32"     # f32 | bf16: the gradient of a bf16 compute copy
    scan_unroll: bool = False   # inert in the port
    model_axis: int = MODEL_AXIS_SIZE
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    attn_impl: str = "padded_heads"  # inert in the port

    # ------------------------------------------------------------- padding
    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def padded_heads(self) -> tuple[int, int]:
        """(KVp, Gp): minimal padded kv-head count and group size such that
        KVp*Gp is divisible by the model axis and the original q->kv group
        mapping embeds at (kv, g<G)."""
        kv, g = self.n_kv_heads, self.group_size
        best = None
        for kvp in range(kv, kv + self.model_axis + 1):
            for gp in range(g, g + self.model_axis + 1):
                hp = kvp * gp
                if hp % self.model_axis == 0:
                    if best is None or hp < best[0] * best[1]:
                        best = (kvp, gp)
        return best

    @property
    def n_heads_padded(self) -> int:
        kvp, gp = self.padded_heads
        return kvp * gp

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // 256) * 256

    def head_mask(self) -> torch.Tensor:
        """(KVp, Gp) float32: 1.0 for real heads, 0.0 for padding."""
        kvp, gp = self.padded_heads
        m = torch.zeros((kvp, gp), dtype=torch.float32)
        m[: self.n_kv_heads, : self.group_size] = 1.0
        return m

    def vocab_mask(self) -> torch.Tensor:
        """(Vp,) float32 additive logits mask: 0 for real ids, -1e9 for padding."""
        m = torch.zeros((self.padded_vocab,), dtype=torch.float32)
        m[self.vocab :] = -1e9
        return m


class ParamFactory:
    """Draws parameters from one explicit :class:`torch.Generator`, in the
    order of the calls: normal × fan_in^-0.5 (``dense``), ones and zeros.
    Values are drawn in float32 and stored in bf16, except the entries a
    family module lists in its ``F32_ENTRIES`` (``make``); with
    ``masters=True`` every entry is stored in float32, the training
    masters, with the same draws.  The JAX
    package's ``PRNGKey`` streams are not reproduced: tests carry JAX's
    weights over with ``models.weights.params_from_jax``."""

    def __init__(self, seed: int, device: torch.device, f32_entries=frozenset(),
                 masters: bool = False):
        self.device = torch.device(device)
        self.dtype = torch.float32 if masters else torch.bfloat16
        self.f32_entries = f32_entries
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def make(self, name: str, shape: tuple, kind: str) -> torch.Tensor:
        """Entry ``name`` of ``shape`` by its init ``kind`` (dense, ones,
        zeros), with JAX's fan-in: the per-layer shape's second-to-last
        dimension.  An entry of ``f32_entries`` (never ``dense``) is kept in
        float32: the JAX package uses it as an fp32 master, with no cast."""
        if kind == "dense":
            return self.dense(shape, fan_in=shape[-2])
        dtype = torch.float32 if name in self.f32_entries else self.dtype
        return torch.full(shape, 1.0 if kind == "ones" else 0.0, dtype=dtype,
                          device=self.device)

    def dense(self, shape: tuple, fan_in: int) -> torch.Tensor:
        """Normal × fan_in^-0.5; a stacked shape is drawn one leading slice at
        a time, so the float32 draw never holds more than one layer."""
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        slices = out if len(shape) > 2 else out[None]
        for s in slices:
            s.copy_(torch.randn(s.shape, generator=self.gen, dtype=torch.float32,
                                device=self.device) * fan_in ** -0.5)
        return out


def make_remat(cfg: ModelConfig, fn):
    """``fn`` rematerialised in the backward pass when ``cfg.remat`` (JAX's
    ``make_remat``): ``torch.utils.checkpoint`` keeps the inputs and runs
    ``fn`` again for its gradient, so a layer's activations live only while
    that layer's gradient is computed.  ``remat_policy="weights"`` saves
    the FSDP-gathered weights in JAX; on one card no weight is gathered, so
    it behaves as ``"none"``."""
    if not cfg.remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def layer_slices(stacked: dict, n: int) -> list[dict]:
    """The ``n`` per-layer views of a stacked ``{name: (n, ...)}`` tree, by
    one ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would add a zero-filled full-size
    gradient a layer."""
    cols = {k: t.unbind(0) for k, t in stacked.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def count_params(shapes) -> int:
    """Total element count of a ``param_shapes`` tree."""
    if isinstance(shapes, dict):
        return sum(count_params(v) for v in shapes.values())
    if isinstance(shapes, list):
        return sum(count_params(v) for v in shapes)
    n = 1
    for s in shapes:
        n *= int(s)
    return n


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes for ``cfg``, allocating nothing: the JAX
    package's ``abstract_init`` tree (the transformer family's ``{"top":
    {name: shape}, "groups": [{name: (n_groups, ...)}]}``; the other
    families' in their modules)."""
    from repro_torch.models.registry import get_module

    return get_module(cfg).param_shapes(cfg)
