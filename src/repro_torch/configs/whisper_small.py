"""whisper-small [audio]: enc-dec, 12L each, d=768 12H (kv=12) d_ff=3072
vocab=51865 (padded to 51968), head_dim 64.  Conv/mel frontend is a STUB:
the caller supplies precomputed frame embeddings (B, seq // 2, d).  [arXiv:2212.04356]"""

import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        n_layers=12,
        n_enc_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab=51865,
        norm="layernorm",
        frontend="frames",
        frontend_len_div=2,   # encoder frames = seq // 2
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512, model_axis=2, q_chunk=16,
    )
