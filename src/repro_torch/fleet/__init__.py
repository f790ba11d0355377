"""Multi-model ``.toad`` fleet serving of the port: registry + dedup + router.

The paper's 4-16x artifact shrink compounds at the serving node: a fleet
host keeps hundreds of compressed forests resident (per-tenant, per-region,
per-A/B-arm) where a pointer-layout deployment kept a handful.  This
package is that layer, module for module the JAX package's ``repro.fleet``,
on a device (the card unless ``device="cpu"`` is asked for):

* :mod:`repro_torch.fleet.registry` — :class:`ModelRegistry`:
  toadcheck-verified admission, ``(model_id, version)`` tracking, atomic
  hot-swap.
* :mod:`repro_torch.fleet.dedup` — :class:`TablePool` content-hash
  interning of threshold/leaf codebook tables across models, on the host
  and as one tensor per device that same-ladder models' kernels share, and
  :func:`fleet_memory_report` (per-model vs shared resident bytes).
* :mod:`repro_torch.fleet.engine` — :class:`FleetEngine`: routes by
  model_id, batches same-model requests across tenants through one
  ``MicroBatchEngine`` worker per hot model (LRU), drains old versions on
  hot-swap.
* :mod:`repro_torch.fleet.faults` — :class:`FaultPlan`: deterministic fault
  injection (predict raise, worker crash, admit failure, slow predict)
  behind the engines' test-only hook, plus the :class:`FutureLedger`
  stranded-future leak checker.

Launch via ``python -m repro_torch.launch.fleet --models dir/`` (or
``repro_torch.launch.serve --arch toad-fleet --models dir/``).
"""

from repro_torch.fleet.dedup import TablePool, fleet_memory_report, intern_model_tables
from repro_torch.fleet.engine import FleetEngine, FleetStats
from repro_torch.fleet.faults import (  # noqa: F401  (FAULT_POINTS: importable)
    FAULT_POINTS,
    Fault,
    FaultPlan,
    FutureLedger,
    InjectedFault,
)
from repro_torch.fleet.registry import ModelEntry, ModelRegistry, UnknownModelError

__all__ = [
    "Fault",
    "FaultPlan",
    "FleetEngine",
    "FleetStats",
    "FutureLedger",
    "InjectedFault",
    "ModelEntry",
    "ModelRegistry",
    "TablePool",
    "UnknownModelError",
    "fleet_memory_report",
    "intern_model_tables",
]
