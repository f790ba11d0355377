"""The benchmark's tests: the harness, the reference and the counting
functions on the CPU at small sizes; tests marked ``gpu`` need the card and
skip without it (they decide inside the test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips inside the test without one)")
