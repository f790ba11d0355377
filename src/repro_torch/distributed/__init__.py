"""Collectives over ``torch.distributed`` process groups and atomic
checkpoints in the JAX package's format (the port's counterpart of
``repro.distributed``: ``collectives``, ``checkpoint``)."""

from repro_torch.distributed.collectives import (
    all_reduce_sum,
    ef_quantized_psum,
    process_group,
    quantized_psum,
)

__all__ = ["all_reduce_sum", "ef_quantized_psum", "process_group", "quantized_psum"]
