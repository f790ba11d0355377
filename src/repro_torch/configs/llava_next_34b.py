"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The anyres vision tower is a STUB: the caller supplies patch embeddings
(seq//4 of the sequence, ``batch["embeds"]``) concatenated before the
text tokens.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""

import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab=64000,
        frontend="patches",
        frontend_len_div=4,   # patch embeds = seq // 4
        rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, d_model=64, n_heads=7, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, model_axis=2, q_chunk=16,
    )
