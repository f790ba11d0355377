"""Collectives over a ``torch.distributed`` process group (the port's
counterpart of ``repro.distributed.collectives``).

The LM stack's collectives on a device mesh are differentiable, each with
the backward its use asks for, in this one place: ``all_reduce_sum`` (the
gradient passes through), ``all_gather_dim`` (a weight's FSDP gather,
whose gradient is reduce-scattered, ``reduce_scatter_dim``; or a gather
every rank uses alike, whose gradient is this rank's block) and
``grad_sum`` (the identity, whose gradient is summed over the group).
Every rank issues the same collectives in the same order, forward and
backward, a rematerialised forward included.

``quantized_psum``: symmetric integer quantization before the all-reduce.
A one-element float32 ``all_reduce(MAX)`` agrees on a shared scale, then
the payload moves as integers.  Used for the GBDT histogram all-reduce
(Shi et al. 2022 showed 2-3 bit gradient histograms suffice).

``ef_quantized_psum``: the same, plus an error-feedback residual for
*iterated* reductions of a fixed-shape tensor: the quantization error of
step t is added back into the signal at t+1, so the bias does not
accumulate (Karimireddy et al. 2019).

Wire types.  gloo and NCCL sum int8 and int32 but not int16 (gloo refuses
``torch.int16`` with "Invalid scalar type"; NCCL has no 16-bit integer
type).  So the 8-bit payload moves as int8, 1 B an element (4x fewer than
float32), and the 16-bit payload is carried in int32: **4 B an element on
gloo and NCCL, not 2**, so 16-bit collectives save no bytes over float32
here.  The carried sum equals the int16 sum exactly, by the bound below.

Overflow.  Integer sums wrap on both backends (gloo sums four int8 100s to
-112).  The JAX package scales so that every shard has ``|x / scale| <=
qmax / n`` and reasons that the sum of n shards then stays within qmax.
Rounding breaks that bound: the shard holding the largest ``|x|`` has
``x / scale = qmax / n`` exactly (31.75 for int8 on 4 shards), which rounds
to 32, and four shards at 32 sum to 128, which wraps to -128 (four shards
of 1.0 sum to -4.03 in the JAX package, at 8 and at 16 bits).  The port
clips each shard's integer to ``±floor(qmax / n)``, so the sum of n of
them is at most ``n · floor(qmax / n) <= qmax`` and fits the payload type.
It differs from the JAX package only at cells where a shard's ``|x| /
scale`` rounds past ``floor(qmax / n)``, by one quantum (``scale``) for
each such shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def process_group(axis_name):
    """The process group ``axis_name`` names: ``None`` for none (training on
    one process), a ``ProcessGroup`` as it is, and a string (the JAX
    package's mesh-axis name, such as ``"data"``) for the default group,
    which must be initialised."""
    if axis_name is None or isinstance(axis_name, dist.ProcessGroup):
        return axis_name
    if not isinstance(axis_name, str):
        raise TypeError(f"axis_name must be a ProcessGroup or a str, got {type(axis_name)}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"axis_name={axis_name!r} names the default process group, but "
            "torch.distributed is not initialised: call init_process_group on "
            "every rank first (gbdt.distributed.spawn_data_parallel does)")
    return dist.group.WORLD


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over ``group`` (the default group when ``None``) in place;
    returns ``x``.  Differentiable: the gradient passes through unchanged,
    as the sum of a model's row-parallel partial products needs (Megatron's
    ``g``): every rank's sum is the same and feeds the same loss, so every
    rank holds the whole gradient of the sum, which is that of each
    partial term."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group``, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """``dist.all_gather`` into views of one tensor: gloo gathers CUDA
    tensors with it (staged through host memory inside gloo), as NCCL does,
    and ``all_gather_into_tensor`` is deprecated in newer torch."""
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
    return out.movedim(0, dim).flatten(dim, dim + 1)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, of which this rank keeps its block
    along ``dim`` (``x.shape[dim]`` split evenly over the group, in rank
    order): ``dist.reduce_scatter``, the all-gather's transpose; ``x``
    itself on a group of one."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    blocks = [b.contiguous() for b in x.chunk(n, dim)]
    out = torch.empty_like(blocks[0])
    dist.reduce_scatter(out, blocks, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, grad):
        ctx.dim, ctx.group, ctx.n, ctx.grad = dim, group, n, grad
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "block":
            i = dist.get_rank(ctx.group)
            return g.chunk(ctx.n, ctx.dim)[i], None, None, None, None
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None, None, None


def all_gather_dim(x: torch.Tensor, dim: int, group, grad: str = "reduce_scatter"
                   ) -> torch.Tensor:
    """``group``'s shards of ``x`` concatenated along ``dim`` in the group's
    rank order (a new tensor); ``x`` itself on a group of one.

    Differentiable, with the backward ``grad`` names, as the gathered
    tensor's use asks:

    * ``"reduce_scatter"`` (a weight's FSDP gather, each rank using the
      whole weight on its own rows of the batch): the gathered gradient
      summed over the group, this rank's block kept (:func:`reduce_scatter_dim`);
    * ``"block"`` (a tensor every rank of the group uses alike, such as the
      vocabulary-parallel logits of one loss): this rank's block of the
      gradient, which every rank holds whole, unsummed."""
    if grad not in ("reduce_scatter", "block"):
        raise ValueError(f"grad must be reduce_scatter or block, got {grad!r}")
    n = dist.get_world_size(group)
    if n == 1:
        return x
    return _AllGather.apply(x, dim, group, n, grad)


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def grad_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``group`` (Megatron's
    ``f``): where a tensor that every rank holds whole feeds this rank's
    block of a product (a column-parallel weight, its heads, its experts),
    each rank's gradient is a partial term of the whole.  ``x`` on a group
    of one."""
    if dist.get_world_size(group) == 1:
        return x
    return _GradSum.apply(x, group)


def all_reduce_count(n: int, group, device) -> int:
    """The sum of ``n`` over ``group``'s ranks: an int64 all-reduce on
    ``device``, read back once.  On the meta device (a trace: tensors
    without values) nothing can be read back, and every rank is taken to
    hold ``n``, so the sum is ``n`` times the group's size."""
    count = all_reduce_sum(torch.tensor([n], dtype=torch.int64, device=device), group)
    return n * dist.get_world_size(group) if count.is_meta else int(count)


def _shared_max(x: torch.Tensor, group) -> torch.Tensor:
    """``max |x|`` over every shard of ``group``, a 0-d tensor."""
    amax = torch.max(torch.abs(x)).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return amax.reshape(())


def quantized_psum(x: torch.Tensor, group=None, bits: int = 16) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` with an integer payload (module
    docstring: int8 on the wire at 8 bits, int32 at 16).

    The scale takes the group's size n, so the sum cannot overflow the
    ``bits``-wide type: each shard keeps ``floor(qmax / n)`` quantization
    levels a sign.  ``torch.round`` rounds half to even, as ``jnp.round``.
    Returns a new tensor; ``x`` is not modified.
    """
    if bits not in (8, 16):
        raise ValueError(f"payload must be 8 or 16 bits, got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    n = dist.get_world_size(group)
    qlim = float(int(qmax) // n)
    scale = torch.clamp(_shared_max(x, group) * n / qmax, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -qlim, qlim)
    q = q.to(torch.int8 if bits == 8 else torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(x.dtype) * scale


def ef_quantized_psum(
    x: torch.Tensor, err: torch.Tensor, group=None, bits: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed all-reduce.

    Args:
      x: local contribution (e.g. a local gradient shard).
      err: residual carried from the previous step (same shape; zeros at t=0).

    Returns:
      (all-reduced dequantized value, new residual).  The integers are
      summed as int32, as in the JAX package, so no sum wraps.
    """
    if bits not in (8, 16):
        raise ValueError(f"payload must be 8 or 16 bits, got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    signal = x + err
    scale = torch.clamp(_shared_max(signal, group) / qmax, min=1e-30)
    q = torch.clamp(torch.round(signal / scale), -qmax, qmax)
    new_err = signal - q * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(x.dtype) * scale, new_err
