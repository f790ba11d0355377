"""Uniform model interface of the port (``repro.models.registry``).

The transformer family (``dense``, ``moe``, ``vlm``) is ported; ``rwkv``,
``hybrid`` and ``encdec`` come with the next slice (ROADMAP queue A,
slice 10) and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch._device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.base import ModelConfig

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer}
_LATER = ("rwkv", "hybrid", "encdec")


def get_module(cfg: ModelConfig):
    """The module implementing ``cfg.family``."""
    if cfg.family in _FAMILY:
        return _FAMILY[cfg.family]
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not in the port yet "
            f"(ROADMAP queue A, slice 10: rwkv6, rglru and whisper)")
    raise ValueError(f"unknown model family {cfg.family!r}")


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
    ``device="cpu"``): ``init(seed)``, ``param_shapes()``,
    ``alloc_cache(batch, max_seq)``, ``prefill(params, batch, max_seq=,
    stats=)`` and ``decode_step(params, cache, token, stats=)``.
    ``prefill`` and ``decode_step`` raise ``ValueError`` when the params,
    the batch, the cache or the token lie on another device."""
    mod = get_module(cfg)
    dev = resolve_device(device)

    def prefill(params, batch, max_seq=None, stats=None):
        _require_on(dev, params=params, batch=batch)
        return mod.prefill(cfg, params, batch, max_seq, stats)

    def decode_step(params, cache, token, stats=None):
        _require_on(dev, params=params, cache=cache, token=token)
        return mod.decode_step(cfg, params, cache, token, stats)

    return SimpleNamespace(
        cfg=cfg,
        module=mod,
        device=dev,
        init=lambda seed=0: mod.init(cfg, seed, dev),
        param_shapes=lambda: mod.param_shapes(cfg),
        alloc_cache=lambda batch, max_seq: mod.alloc_cache(cfg, batch, max_seq, dev),
        prefill=prefill,
        decode_step=decode_step,
    )
