"""The paper's own workload: ToaD GBDT training (a copy of
``repro.configs.toad_gbdt``).

A large synthetic binned dataset (16.7M rows: the JAX package shards it over
a full mesh) with production-scale per-level histograms
(nodes × d × bins × 3).  On one card the port trains it at fewer rows; the
row count is the caller's cut.
"""

import dataclasses

from repro_torch.gbdt.trainer import GBDTConfig


@dataclasses.dataclass(frozen=True)
class ToadWorkload:
    rows: int = 1 << 24          # 16.7M samples
    n_features: int = 256
    n_bins: int = 256
    gbdt: GBDTConfig = GBDTConfig(
        task="binary",
        n_rounds=8,
        max_depth=8,
        learning_rate=0.1,
        toad_penalty_feature=8.0,
        toad_penalty_threshold=2.0,
        leaf_capacity=8192,
    )


def config() -> ToadWorkload:
    return ToadWorkload()


def reduced() -> ToadWorkload:
    return ToadWorkload(
        rows=4096,
        n_features=16,
        n_bins=32,
        gbdt=dataclasses.replace(config().gbdt, n_rounds=4, max_depth=3),
    )
