"""Estimator API of the port: ``ToadModel``, the predictor backends, the
versioned .toad artifact and the micro-batching serving engine."""

from repro_torch.api.artifact import (
    TOAD_FORMAT_VERSION,
    ArtifactError,
    LoadedArtifact,
    load_artifact,
    load_checked,
    save_artifact,
)
from repro_torch.api.backends import (
    PredictorBackend,
    available_backends,
    get_backend,
    list_backends,
    register_backend,
    resolve_backend,
)
from repro_torch.api.engine import (
    EarlyExitPredictor,
    EngineStats,
    EngineStopped,
    GBDTEngine,
    MicroBatchEngine,
)
from repro_torch.gbdt.early_exit import EarlyExitPolicy
from repro_torch.api.model import NotFittedError, ToadModel
from repro_torch.core.pipeline import CompressionSpec
