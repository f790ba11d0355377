"""llama3.2-3b [dense]: 28L d=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
24 q-heads pad to 32 for the 16-way TP axis.  [hf:meta-llama/Llama-3.2-1B]"""

import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=128256,
        rope_theta=5e5,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab=512, model_axis=2, q_chunk=16,
    )
