"""Forests, binning, losses and the trainer."""

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
