"""Fleet serving of the port.  For now only its fault injection
(:mod:`repro_torch.fleet.faults`), which the serving engine's fault hooks
use; the registry, table dedup and the fleet engine come with the fleet
slice."""

from repro_torch.fleet.faults import (
    FAULT_POINTS,
    Fault,
    FaultPlan,
    FutureLedger,
    InjectedFault,
)

__all__ = ["FAULT_POINTS", "Fault", "FaultPlan", "FutureLedger", "InjectedFault"]
