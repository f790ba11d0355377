"""Collectives over ``torch.distributed`` process groups (the port's
counterpart of ``repro.distributed``; its ``checkpoint`` module belongs to
the LM stack and is not ported yet)."""

from repro_torch.distributed.collectives import (
    all_reduce_sum,
    ef_quantized_psum,
    process_group,
    quantized_psum,
)

__all__ = ["all_reduce_sum", "ef_quantized_psum", "process_group", "quantized_psum"]
