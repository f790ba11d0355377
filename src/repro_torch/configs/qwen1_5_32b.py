"""qwen1.5-32b [dense]: 64L d=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064, QKV bias.  40 heads pad to 48.  [hf:Qwen/Qwen1.5-0.5B]"""

import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=5, n_kv_heads=5, head_dim=16,
        d_ff=160, vocab=512, model_axis=2, q_chunk=16,
    )
