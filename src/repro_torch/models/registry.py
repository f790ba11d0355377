"""Uniform model interface of the port (``repro.models.registry``) over
the four family modules, for serving and training: the transformer
(``dense``, ``moe``, ``vlm``), RWKV-6 (``rwkv``), the RG-LRU hybrid
(``hybrid``) and the encoder-decoder (``encdec``).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch._device import resolve_device
from repro_torch.models import rglru, rwkv6, transformer, whisper
from repro_torch.models.base import ModelConfig

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "rwkv": rwkv6, "hybrid": rglru, "encdec": whisper}


def get_module(cfg: ModelConfig):
    """The module implementing ``cfg.family``."""
    if cfg.family not in _FAMILY:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return _FAMILY[cfg.family]


def _tensors(tree):
    """Every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _require_on(dev: torch.device, **trees) -> None:
    """Raise unless every tensor of ``trees`` lies on ``dev``: a model on
    the card never computes quietly on the CPU, nor the other way round."""
    for what, tree in trees.items():
        for t in _tensors(tree):
            if t.device != dev:
                raise ValueError(f"{what} holds a tensor on {t.device}, but the model "
                                 f"is on {dev}: move it there first")


def get_model(cfg: ModelConfig, device="cuda") -> SimpleNamespace:
    """``cfg``'s model on ``device`` (the card unless the caller passes
    ``device="cpu"``): ``init(seed, masters=False)`` (bf16 weights for
    serving, float32 masters for training with ``masters=True``),
    ``param_shapes()``, ``alloc_cache(batch, max_seq)`` (an
    encoder-decoder's also takes ``enc_seq=``, its encoder length),
    ``prefill(params, batch, max_seq=, stats=)``, ``decode_step(params,
    cache, token, stats=)``, the position being ``cache["length"]``, and
    ``train_loss(params, batch)``, the scalar mean cross entropy over
    ``batch["labels"] >= 0``.  ``prefill``, ``decode_step`` and
    ``train_loss`` raise ``ValueError`` when the params, the batch, the
    cache or the token lie on another device."""
    mod = get_module(cfg)
    dev = resolve_device(device)

    def prefill(params, batch, max_seq=None, stats=None):
        _require_on(dev, params=params, batch=batch)
        return mod.prefill(cfg, params, batch, max_seq, stats)

    def decode_step(params, cache, token, stats=None):
        _require_on(dev, params=params, cache=cache, token=token)
        return mod.decode_step(cfg, params, cache, token, stats)

    def train_loss(params, batch):
        _require_on(dev, params=params, batch=batch)
        return mod.train_loss(cfg, params, batch)

    return SimpleNamespace(
        cfg=cfg,
        module=mod,
        device=dev,
        init=lambda seed=0, masters=False: mod.init(cfg, seed, dev, masters),
        param_shapes=lambda: mod.param_shapes(cfg),
        alloc_cache=lambda batch, max_seq, **kw: mod.alloc_cache(cfg, batch, max_seq, dev,
                                                                 **kw),
        prefill=prefill,
        decode_step=decode_step,
        train_loss=train_loss,
    )
