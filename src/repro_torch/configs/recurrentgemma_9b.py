"""recurrentgemma-9b [hybrid]: 38L d=4096, RG-LRU + local MQA attention in
a 2:1 pattern, window 2048, 16H kv=1 head_dim 256, d_ff=12288,
vocab=256000.  Runs long_500k (state is O(window)).  [arXiv:2402.19427]"""

import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,             # 12 × (rglru, rglru, attn) + (rglru, rglru)
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab=256000,
        pattern=("rglru", "rglru", "attn"),
        local_window=2048,
        d_rnn=4096,
        rope_theta=1e4,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, d_rnn=64, local_window=16, model_axis=2, q_chunk=16,
    )
