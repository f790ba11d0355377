"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) d_ff=13824 vocab=100352,
LayerNorm flavor, head_dim 160.  [hf:stabilityai/stablelm-2-1_6b]"""

import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab=100352,
        norm="layernorm",
        qk_norm=True,
        rope_theta=1e4,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, model_axis=2, q_chunk=16,
    )
