"""rwkv6-1.6b "Finch" [ssm]: 24L d=2048 (attention-free) d_ff=7168
vocab=65536, head_dim 64, data-dependent decay.  Runs long_500k (O(1)
state).  [arXiv:2404.05892]"""

import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="rwkv",
        n_layers=24,
        d_model=2048,
        n_heads=32,          # d_model / head_dim
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab=65536,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, model_axis=2,
    )
