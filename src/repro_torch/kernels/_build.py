"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, loaded with :mod:`ctypes`
(no PyTorch headers, so a build takes seconds).  Libraries go to
``build/torch_kernels/`` at the repository root, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing is built at import: :func:`load` builds at first use, and
:func:`build_all` compiles every source at once, one ``nvcc`` each, all
started together.

No ``--use_fast_math``: the kernels rely on IEEE comparisons (NaN compares
false).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ptxas output (registers, shared memory, spills) of each source built by
#: this process, by source name
ptxas_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source on the machine with the card"
        )
    return found


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library is built."""
    lib = _library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return lib, tmp, proc


def _finish(name: str, lib: Path, tmp: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    ptxas_log[name] = log
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, str]:
    """Compile every stale source in parallel; returns the ptxas logs."""
    with _lock:
        started = {name: _start(name) for name in sources()}
        errors = []
        for name, job in started.items():
            if job is None:
                continue
            try:
                _finish(name, *job)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
    return dict(ptxas_log)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, *job)
            lib = ctypes.CDLL(str(_library_path(name)))
            _libs[name] = lib
        return lib
