"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192,
vocab=202048, 128 experts top-1, dense/MoE interleaved 1:1 (≈400B total,
≈17B active).  Adafactor (factored 2nd moment) keeps optimizer state within
HBM at 256 chips.  [hf:meta-llama/Llama-4-Scout-17B-16E]"""

import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=202048,
        n_experts=128,
        top_k=1,
        moe_interleave=2,     # dense, moe, dense, moe, ...
        capacity_factor=1.25,
        rope_theta=5e5,
        optimizer="adafactor",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, head_dim=16,
        d_ff=64, vocab=512, n_experts=8, top_k=1, model_axis=2, q_chunk=16,
    )
