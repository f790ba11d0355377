"""Workload and architecture registry of the port (``repro.configs``).

``get_gbdt_config(name)`` returns the paper's GBDT workload (``reduced=True``
a same-family miniature for CPU smoke runs).  ``get_config(name)`` returns
an LM architecture's full ``ModelConfig`` and ``get_reduced(name)`` a
same-family miniature; ``ARCHS`` holds every LM architecture of the JAX
package: the transformer family (dense, MoE, VLM), the recurrent ones
(RWKV-6, the RG-LRU hybrid) and the encoder-decoder (whisper).
"""

from __future__ import annotations

from repro_torch.configs import (
    llama3_2_3b,
    llama4_maverick_400b_a17b,
    llava_next_34b,
    olmoe_1b_7b,
    qwen1_5_32b,
    qwen3_4b,
    recurrentgemma_9b,
    rwkv6_1_6b,
    stablelm_12b,
    toad_gbdt,
    whisper_small,
)

ARCHS = {
    "qwen3-4b": qwen3_4b,
    "llama3.2-3b": llama3_2_3b,
    "qwen1.5-32b": qwen1_5_32b,
    "stablelm-12b": stablelm_12b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "whisper-small": whisper_small,
    "recurrentgemma-9b": recurrentgemma_9b,
    "llava-next-34b": llava_next_34b,
}  # the JAX package's order, which the dry-run sweep's cells follow

GBDT_CONFIGS = {"toad_gbdt": toad_gbdt}


def _norm_gbdt(name: str) -> str:
    return name.replace("-", "_")


def is_gbdt_arch(name: str) -> bool:
    """True for the paper's own workload names ('toad-gbdt' / 'toad_gbdt')."""
    return _norm_gbdt(name) in GBDT_CONFIGS


def get_gbdt_config(name: str, reduced: bool = False):
    mod = GBDT_CONFIGS[_norm_gbdt(name)]
    return mod.reduced() if reduced else mod.config()


def get_config(name: str):
    return ARCHS[name].config()


def get_reduced(name: str):
    return ARCHS[name].reduced()


def list_archs():
    return list(ARCHS)
