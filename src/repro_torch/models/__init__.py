"""The port's LM stack (``repro.models``) for serving and training: the transformer
family (dense, MoE, VLM), RWKV-6, the RG-LRU hybrid and the whisper
encoder-decoder.  ``get_model(cfg, device)`` is the entry point."""

from repro_torch.models.base import ModelConfig, count_params, param_shapes, param_specs
from repro_torch.models.registry import get_model
from repro_torch.models.weights import params_from_jax, state_from_jax

__all__ = ["ModelConfig", "count_params", "get_model", "param_shapes", "param_specs",
           "params_from_jax", "state_from_jax"]
