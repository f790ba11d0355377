"""Compressed collectives over a ``torch.distributed`` process group (the
port's counterpart of ``repro.distributed.collectives``).

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


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over ``group`` (the default group when ``None``) in place;
    returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group``, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``group``'s shards of ``x`` concatenated along ``dim`` in the group's
    rank order (a new tensor); ``x`` itself on a group of one.

    ``dist.all_gather`` into views of one tensor: gloo gathers CUDA tensors
    with it (staged through host memory inside gloo), as NCCL does, and
    ``all_gather_into_tensor`` is deprecated in newer torch."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
    return out.movedim(0, dim).flatten(dim, dim + 1)


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
