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
``train_loss`` where JAX does (:func:`make_remat`); ``remat_policy`` runs
as ``"none"`` (:func:`make_remat` says why); ``grad_dtype`` selects the training
step's bf16 compute copy (``train/loop.py``).

On a device mesh (``launch.mesh.RankMesh``: ``torch.distributed`` ranks
on ``("data", "model")`` axes, ``"pod"`` too for two pods) every rank runs
the same code on its own shards, as JAX's program runs on each device
after XLA partitions it.  A tensor's placement comes from the same
sharding tuples that ``param_specs`` and ``cache_specs`` return
(:func:`full_spec`): :func:`shard` cuts this rank's block (padded as
``launch.mesh.shard_shape`` pads), :func:`wcast` gathers a weight's FSDP
``"data"`` blocks at its use (JAX's ``wcast`` with a gathered spec), and
:func:`dp_spec` names the batch's axes.  Activations carry no placement
object: the family module's per-rank code keeps the batch's rows of its
data shard and says, at each product, whether a dimension is split over
``"model"`` (the collectives are explicit: ``distributed.collectives``).
The per-rank helpers the four family modules share live here: a batch's
rows (:func:`_rows`, over the axes :func:`batch_axes` names from JAX's
``dp``; ``dp=None`` keeps the batch whole on every rank), a dimension's
``"model"`` block (:func:`_block`), a layer's weights with their FSDP
blocks gathered (:func:`_gathered`), a ``"model"`` gather
(:func:`_model_gather`), the vocabulary-parallel embedding
(:func:`_embed_tokens`) and logits (:func:`vocab_logits`, kept as the
rank's vocabulary block for the training loss), and a training batch's
rows (:func:`_train_rows`).  They train
too: each collective carries the backward its use asks for
(``distributed.collectives``): the FSDP gather's gradient is
reduce-scattered to the shard, a ``"model"`` gather's is the rank's block,
and a tensor whole on every ``"model"`` rank that feeds the rank's block
of a product has its gradient summed (:func:`_model_grad_sum`).

Weights are bf16 for serving (``init`` and ``params_from_jax`` cast once
at load) and float32 masters for training (``masters=True``, JAX's
storage): every module casts a weight to the activations' dtype at its
use, as JAX's ``wcast`` does, which is free for bf16 weights and carries
the gradient through the cast to an fp32 master.
"""

from __future__ import annotations

import dataclasses
import math

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

    def draw(self, name: str, shape: tuple, kind: str, spec=None, mesh=None,
             stacked: bool = False) -> torch.Tensor:
        """:meth:`make`'s entry; on a ``mesh`` this rank's shard of it
        (:func:`shard` by the entry table's ``spec``, a ``stacked`` shape's
        leading layer axis replicated): every rank draws the entry whole, in
        the same order, and cuts its block at once."""
        t = self.make(name, shape, kind)
        if mesh is None:
            return t
        return shard(t, full_spec(spec, len(shape) - stacked, stacked), mesh)

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
    that layer's gradient is computed (and the recompute stops at the last
    tensor the backward saved).  ``remat_policy="weights"`` saves the
    FSDP-gathered weights in JAX; the port runs every policy as ``"none"``:
    on a mesh a layer's weights are gathered again in its recompute, on one
    card none is gathered."""
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


def full_spec(spec, rank: int, stacked: bool = False) -> tuple:
    """An entry table's sharding as one entry a dimension of a leaf of
    ``rank`` dimensions (the per-layer shape's rank).

    The tables write JAX's ``PartitionSpec`` entries: ``None`` for a leaf
    replicated whole, else a tuple with, a dimension, an axis name, a tuple
    of axis names or ``None``, trailing dimensions left out.  Those are
    padded with ``None``; ``stacked`` prefixes the stacked layer axis,
    replicated, as JAX's ``stack_layer_trees`` does."""
    spec = tuple(spec or ())
    spec = spec + (None,) * (rank - len(spec))
    return (None,) + spec if stacked else spec


def dp_spec(axis_names) -> tuple:
    """The batch-sharding axes: ``("pod", "data")`` on a multi-pod mesh."""
    return ("pod", "data") if "pod" in axis_names else ("data",)


def with_dp(specs, dp):
    """A tree of ``(shape, dtype, sharding)`` leaves (a ``cache_specs``
    template) with its ``"data"`` entries rewritten to the batch's axes
    ``dp``."""
    def fix(_, leaf):
        shape, dtype, spec = leaf
        return shape, dtype, tuple(dp if e == "data" else e for e in spec)

    return map_leaves(fix, specs)


def shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` sharded as ``spec`` on
    ``mesh`` (a ``RankMesh``), as a new tensor: block ``i`` of a dimension
    of ``n`` split ``p`` ways is ``[i·c, min((i+1)·c, n))`` with ``c =
    ceil(n / p)`` (``launch.mesh.shard_shape``), zero-padded to ``c``, so
    an uneven split leaves the last blocks short (or empty) and padded.
    The block is the one ``jax.device_put(t, NamedSharding(mesh, spec))``
    puts on the device at this rank's coordinates."""
    from repro_torch.launch.mesh import entry_index, shard_shape

    spec = full_spec(spec, t.dim())
    padded = shard_shape(t.shape, spec, mesh)
    idx = []
    for n, c, e in zip(t.shape, padded, spec):
        lo = min(entry_index(e, mesh) * c, n)
        idx.append(slice(lo, min(lo + c, n)))
    block = t[tuple(idx)]
    if tuple(block.shape) == padded:
        return block.clone()
    out = torch.zeros(padded, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, n) for n in block.shape)] = block
    return out


def _axis_names(entry) -> tuple:
    """The axis names of one sharding entry: ``None``, a name or a tuple."""
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


FSDP_AXES = ("pod", "data")  # the storage axes a weight is gathered over at its use


def wcast(w: torch.Tensor, dtype, mesh=None, shape=None, spec=None) -> torch.Tensor:
    """A weight cast for compute (JAX's ``wcast``): ``w`` in ``dtype``; on a
    mesh, ``w`` is this rank's shard of a weight of ``shape`` sharded as
    ``spec``, and its FSDP blocks (the dimensions ``spec`` splits over
    ``"data"``) are all-gathered, leaving the ``"model"`` split: JAX's
    gathered spec, the storage spec with ``"data"`` dropped.  The padding
    of an uneven split is cut off."""
    from repro_torch.distributed.collectives import all_gather_dim

    out = w.to(dtype)
    if mesh is None:
        return out
    for dim, e in enumerate(full_spec(spec, len(shape))):
        names = _axis_names(e)
        gathered = [a for a in names if a in FSDP_AXES]
        if not gathered:
            continue
        if len(gathered) != len(names) or len(names) != 1:
            raise ValueError(f"cannot gather dimension {dim} sharded as {e!r}")
        out = all_gather_dim(out, dim, mesh.group(names[0])).narrow(dim, 0, shape[dim])
    return out


# --------------------------------------------------------------------------
# one rank's part of a meshed step, shared by the four family modules
# --------------------------------------------------------------------------

MESH_DP = "mesh"  # a ``dp`` argument's default: the mesh's ``dp_spec``


def batch_axes(mesh, dp=MESH_DP):
    """The axes the batch is split over (JAX's ``dp``): ``dp_spec`` of the
    mesh for :data:`MESH_DP`, else ``dp`` itself, a tuple of axis names or
    ``None``, the batch whole on every ``"data"`` rank (what
    ``launch.input_specs._dp`` picks for a batch the data axes cannot
    cover, such as ``long_500k``'s one row)."""
    return dp_spec(mesh.axis_names) if dp == MESH_DP else dp


def _split(mesh, batch: int, max_seq: int | None = None, dp=MESH_DP) -> int:
    """The number of data shards; refuses a batch the axes ``dp`` names do
    not divide, or a cache the ``"model"`` axis does not divide: nothing is
    padded."""
    dp = batch_axes(mesh, dp)
    n_dp = math.prod(mesh.axis_size(a) for a in _axis_names(dp))
    if batch % n_dp:
        raise ValueError(f"the batch of {batch} rows does not divide over the "
                         f"{n_dp} shards of the data axes {dp}")
    n_model = mesh.axis_size("model")
    if max_seq is not None and max_seq % n_model:
        raise ValueError(f"the cache's {max_seq} slots do not divide over the "
                         f"{n_model} ranks of the model axis")
    return n_dp


def rank_specs(specs, mesh, dp=MESH_DP):
    """A tree of ``(shape, dtype, sharding)`` leaves (a ``cache_specs``
    template) as this rank's shards on ``mesh``: the ``"data"`` entries
    rewritten to the batch's axes ``dp`` (:func:`with_dp`), each shape cut
    to its shard (``launch.mesh.shard_shape``)."""
    from repro_torch.launch.mesh import shard_shape

    return map_leaves(lambda _, leaf: (shard_shape(leaf[0], leaf[2], mesh), *leaf[1:]),
                      with_dp(specs, batch_axes(mesh, dp)))


def _rows(mesh, t, dp=MESH_DP):
    """This rank's rows of a global batch tensor (its data shard); all of
    them with ``dp=None``."""
    from repro_torch.launch.mesh import entry_index

    if mesh is None:
        return t
    b = t.shape[0] // _split(mesh, t.shape[0], dp=dp)
    i = entry_index(batch_axes(mesh, dp), mesh)
    return t[i * b:(i + 1) * b]


def _block(mesh, n: int) -> slice:
    """This rank's ``"model"`` block of a dimension of ``n`` (heads, d_ff,
    vocabulary, d_model), which the axis must divide."""
    if mesh is None:
        return slice(None)
    p, a = mesh.axis_size("model"), mesh.axis_index("model")
    if n % p:
        raise ValueError(f"{n} does not divide over the {p} ranks of the model axis")
    return slice(a * (n // p), (a + 1) * (n // p))


def _gathered(entries: dict, lp: dict, mesh) -> dict:
    """A layer's (or the top's) weights with their ``"data"`` blocks gathered
    (:func:`wcast`); ``lp`` itself without a mesh.  ``entries``: the family
    module's ``{name: (shape, init kind, sharding)}`` table."""
    if mesh is None:
        return lp
    return {k: wcast(t, t.dtype, mesh, entries[k][0], entries[k][2]) for k, t in lp.items()}


def _model_gather(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """``t``'s ``"model"`` blocks along ``dim`` gathered whole; ``t`` itself
    without a mesh or on one ``"model"`` rank (no collective).  Every
    ``"model"`` rank uses the gathered tensor alike, so its gradient is
    this rank's block of the gathered one's, unsummed."""
    from repro_torch.distributed.collectives import all_gather_dim

    if mesh is None or mesh.axis_size("model") == 1:
        return t
    return all_gather_dim(t, dim % t.dim(), mesh.group("model"), grad="block")


def _model_grad_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` itself, with its gradient summed over ``"model"``
    (``collectives.grad_sum``): ``t`` is whole on every ``"model"`` rank and
    feeds this rank's block of a product, heads or experts, so each rank's
    gradient is a partial term.  ``t`` without a mesh or on one rank."""
    from repro_torch.distributed.collectives import grad_sum

    if mesh is None or mesh.axis_size("model") == 1:
        return t
    return grad_sum(t, mesh.group("model"))


def _embed_tokens(top, tokens, mesh=None):
    """The bf16 rows of ``tokens``: JAX casts the table, then gathers; the
    port gathers, then casts (the same values; the gradient sums repeated
    tokens in float32).  With the vocabulary split over ``"model"``, each
    rank gathers the rows in its block, zeros elsewhere, and the sum over
    the group (one non-zero term a row) is exact."""
    from repro_torch.distributed.collectives import all_reduce_sum

    embed = top["embed"]
    if mesh is None or mesh.axis_size("model") == 1:
        return embed[tokens].to(torch.bfloat16)
    ids = tokens - mesh.axis_index("model") * embed.shape[0]
    inside = (ids >= 0) & (ids < embed.shape[0])
    rows = embed[ids.clamp(0, embed.shape[0] - 1)].to(torch.bfloat16)
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return all_reduce_sum(rows, mesh.group("model"))


def vocab_logits(head, x, vocab_mask, mesh=None, gather: bool = True):
    """Logits (..., Vp) float32 of ``x @ head`` with the vocab mask; on a
    mesh ``head`` is this rank's ``"model"`` block of the vocabulary's
    columns, and the blocks are gathered, or with ``gather=False`` kept:
    this rank's (..., Vp / model) block, which the vocabulary-parallel
    cross entropy takes (``transformer._ce_loss``)."""
    x = _model_grad_sum(x, mesh)
    local = (x @ head.to(x.dtype)).float() + vocab_mask[_block(mesh, vocab_mask.shape[0])]
    return _model_gather(local, -1, mesh) if gather else local


def _logits(cfg, top, x, vocab_mask, mesh=None, gather: bool = True):
    """:func:`vocab_logits` of the output head, or of the embedding's
    transpose for a tied one."""
    head = top["embed"].T if cfg.tie_embeddings else top["head"]
    return vocab_logits(head, x, vocab_mask, mesh, gather)


def _train_rows(mesh, batch: dict, dp=MESH_DP) -> dict:
    """This rank's rows of every tensor of a training batch (``batch``
    itself without a mesh).  Training on a mesh splits the global batch
    over every data axis of more than one rank (``dp`` must name them
    all: JAX's step takes the batch ``P(dp)``), so a batch those axes do
    not divide, or a ``dp`` that leaves one whole, raises ``ValueError``."""
    if mesh is None:
        return batch
    _split(mesh, batch["tokens"].shape[0], dp=dp)
    split = set(_axis_names(batch_axes(mesh, dp)))
    whole = [a for a in ("pod", "data") if mesh.axis_size(a) > 1 and a not in split]
    if whole:
        raise ValueError(f"training on a mesh splits the batch over every data axis; "
                         f"dp={dp!r} leaves it whole over {whole}")
    return {k: _rows(mesh, t, dp) for k, t in batch.items()}


def leaves(tree, name=""):
    """``(name, leaf)`` for each leaf of a tree of dicts and lists, ``name``
    the leaf's nearest dict key.  A tuple is a leaf: a shape, a sharding, or
    a ``(shape, dtype, sharding)`` entry."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v, name)
    else:
        yield name, tree


def map_leaves(fn, *trees, name=""):
    """``fn(name, *leaves)`` over parallel trees of dicts and lists (tuples
    are leaves, as in :func:`leaves`), the first tree giving the structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_leaves(fn, *(t[k] for t in trees), name=k) for k in first}
    if isinstance(first, list):
        return [map_leaves(fn, *(t[i] for t in trees), name=name) for i in range(len(first))]
    return fn(name, *trees)


def zeros_of(specs, device):
    """Zeroed tensors for a tree of ``(shape, dtype, sharding)`` leaves, such
    as a family module's ``cache_specs``."""
    return map_leaves(lambda _, leaf: torch.zeros(leaf[0], dtype=leaf[1], device=device), specs)


def count_params(shapes) -> int:
    """Total element count of a ``param_shapes`` tree."""
    return sum(math.prod(shape) for _, shape in leaves(shapes))


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes for ``cfg``, allocating nothing: the JAX
    package's ``abstract_init`` tree (the transformer family's ``{"top":
    {name: shape}, "groups": [{name: (n_groups, ...)}]}``; the other
    families' in their modules)."""
    from repro_torch.models.registry import get_module

    return get_module(cfg).param_shapes(cfg)


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's shardings for ``cfg`` (JAX's ``param_specs``),
    beside :func:`param_shapes`: a tuple a leaf with one entry a dimension
    (``full_spec``)."""
    from repro_torch.models.registry import get_module

    return get_module(cfg).param_specs(cfg)
