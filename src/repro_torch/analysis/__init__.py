"""toadcheck of the port: structural verification of ``.toad`` artifacts.

:mod:`repro_torch.analysis.verify` walks a bundle or an encoded stream
without decoding-to-predict and reports typed
:class:`~repro_torch.analysis.diagnostics.Diagnostic` findings (``TOAD0xx``
for the stream, ``TOAD1xx`` for the bundle), with the JAX package's codes.
``load_artifact(verify=True)`` runs it before decode, ``save_artifact``
after encode, and ``python -m repro_torch.launch.toadcheck`` from the
command line.
"""

from repro_torch.analysis.diagnostics import (
    CATALOG,
    ERROR,
    INFO,
    WARNING,
    Baseline,
    Diagnostic,
    errors,
    format_diagnostics,
)
from repro_torch.analysis.verify import (
    verify_artifact,
    verify_bundle,
    verify_model,
    verify_stream,
)

__all__ = [
    "CATALOG",
    "ERROR",
    "WARNING",
    "INFO",
    "Baseline",
    "Diagnostic",
    "errors",
    "format_diagnostics",
    "verify_artifact",
    "verify_bundle",
    "verify_model",
    "verify_stream",
]
