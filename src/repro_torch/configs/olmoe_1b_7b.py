"""olmoe-1b-7b [moe]: 16L d=2048 16H (kv=16) expert d_ff=1024 vocab=50304,
64 experts top-8, qk_norm.  [arXiv:2409.02060]"""

import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab=50304,
        qk_norm=True,
        n_experts=64,
        top_k=8,
        moe_interleave=1,
        rope_theta=1e4,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab=512, n_experts=8, top_k=2, model_axis=2, q_chunk=16,
    )
