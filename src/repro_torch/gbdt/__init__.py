"""Forests, binning, losses and the trainer."""

from repro_torch.gbdt.binning import apply_bins, fit_bins
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
