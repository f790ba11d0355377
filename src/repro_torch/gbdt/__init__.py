"""Forests, binning, losses, the trainer, the baselines and data-parallel
training."""

from repro_torch.gbdt.binning import apply_bins, fit_bins
from repro_torch.gbdt.early_exit import (
    EarlyExitPolicy,
    EarlyExitResult,
    decision_final_mask,
    predict_early_exit,
    predict_label_from_scores,
    remaining_mass,
)
from repro_torch.gbdt.forest import (
    FOREST_FIELDS,
    Forest,
    empty_forest,
    forest_from_numpy,
    forest_to_numpy,
    predict_binned,
    predict_raw,
)
from repro_torch.gbdt.losses import make_loss
from repro_torch.gbdt.trainer import GBDTConfig, train, train_grid

# the JAX package's exports, but ``train_jit`` (PyTorch has no jit to name:
# gbdt/trainer.py), then the port's forest carriers; the baselines
# (gbdt/baselines.py) and data-parallel training (gbdt/distributed.py) are
# imported from their modules, as in the JAX package
__all__ = [
    "apply_bins",
    "fit_bins",
    "EarlyExitPolicy",
    "EarlyExitResult",
    "decision_final_mask",
    "predict_early_exit",
    "predict_label_from_scores",
    "remaining_mass",
    "Forest",
    "empty_forest",
    "predict_binned",
    "predict_raw",
    "make_loss",
    "GBDTConfig",
    "train",
    "train_grid",
    "FOREST_FIELDS",
    "forest_from_numpy",
    "forest_to_numpy",
]
