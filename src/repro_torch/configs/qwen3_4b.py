"""qwen3-4b [dense]: 36L d=2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm, head_dim 128 (q/k project above d_model).  [hf:Qwen/Qwen3-8B]"""

import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab=151936,
        qk_norm=True,
        rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, model_axis=2, q_chunk=16,
    )
