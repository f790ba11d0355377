"""The trainer's configuration (the port's counterpart of
``repro.gbdt.trainer.GBDTConfig``).

Only the configuration is here so far: artifacts store
``dataclasses.asdict(config)``, so loading and saving need the same fields
and defaults as the JAX package.  The trainer itself is still to port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    task: str = "regression"          # regression | binary | multiclass
    n_classes: int = 0
    n_rounds: int = 64                # K boosting rounds (trees per class)
    max_depth: int = 4
    learning_rate: float = 0.1
    reg_lambda: float = 1.0           # λ
    gamma: float = 0.0                # γ per-leaf complexity
    min_child_weight: float = 1e-3
    min_child_samples: int = 1
    toad_penalty_feature: float = 0.0   # ι
    toad_penalty_threshold: float = 0.0 # ξ
    toad_forestsize: float = 0.0      # byte budget; 0 = unlimited
    leaf_capacity: int = 4096         # global leaf-value table capacity
    leaf_match_tol: float = 0.0       # reuse tolerance (0 = exact match)
    leaf_quant: float = 0.0           # optional leaf rounding grid
    cegb_penalty_split: float = 0.0   # CEGB (Peter et al.) per-split cost × n_node/n
    hist_dtype: str = "f32"           # f32 | bf16 g/h rounding (numerics
                                      # ablation); counts always exact f32
    hist_method: str = "auto"         # auto | ref | fused | pallas
    hist_subtract: bool = True        # sibling subtraction at levels >= 1
    hist_quant_bits: int = 0          # 0 = exact fp32 histogram all-reduce;
                                      # 8/16 = quantized collectives
                                      # (data-parallel training only)

    @property
    def n_ensembles(self) -> int:
        return self.n_classes if self.task == "multiclass" else 1
