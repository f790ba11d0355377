"""toadcheck of the port: structural verification of ``.toad`` artifacts,
and the code lint of the port's sources.

:mod:`repro_torch.analysis.verify` walks a bundle or an encoded stream
without decoding-to-predict and reports typed
:class:`~repro_torch.analysis.diagnostics.Diagnostic` findings (``TOAD0xx``
for the stream, ``TOAD1xx`` for the bundle, ``TOAD11x`` for the
``.toadpack`` container), with the JAX package's codes; ``verify_fleet``
checks a fleet's artifacts before the registry admits them.
``load_artifact(verify=True)`` runs it before decode, ``save_artifact``
after encode, ``save_streaming`` after the write, and ``python -m
repro_torch.launch.toadcheck`` from the command line.  :func:`lint_paths`
(:mod:`repro_torch.analysis.lint`) runs the ``TOAD2xx`` rules over source
files, as the JAX package's lint does over its own.
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
from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.verify import (
    verify_artifact,
    verify_bundle,
    verify_fleet,
    verify_model,
    verify_pack,
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
    "lint_paths",
    "verify_artifact",
    "verify_bundle",
    "verify_fleet",
    "verify_model",
    "verify_pack",
    "verify_stream",
]
