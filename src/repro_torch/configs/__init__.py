"""Workload registry of the port: the GBDT part of ``repro.configs``.

``get_gbdt_config(name)`` returns the full workload; ``reduced=True`` a
same-family miniature for CPU smoke runs.  The LM architectures come with
slice 9 of the port.
"""

from __future__ import annotations

from repro_torch.configs import toad_gbdt

GBDT_CONFIGS = {"toad_gbdt": toad_gbdt}


def _norm_gbdt(name: str) -> str:
    return name.replace("-", "_")


def is_gbdt_arch(name: str) -> bool:
    """True for the paper's own workload names ('toad-gbdt' / 'toad_gbdt')."""
    return _norm_gbdt(name) in GBDT_CONFIGS


def get_gbdt_config(name: str, reduced: bool = False):
    mod = GBDT_CONFIGS[_norm_gbdt(name)]
    return mod.reduced() if reduced else mod.config()
