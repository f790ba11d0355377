"""Nothing that a run loads is JAX, the JAX package (``repro``) or the JAX
package's benchmarks, and the reference loads nothing of the program.

Top-level module names are compared whole: ``repro_torch`` is the program,
``repro`` the JAX package it was made from."""

import ast
import json
import subprocess
import sys

import pytest
from bench_small import CELLS, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from bench.core import harness
res, _ = harness.run_cell({name!r}, 7, 0.2, False, "cpu", time.perf_counter(), {over!r})
assert res["correct"], res
mods = {{m: getattr(v, "__file__", None) for m, v in list(sys.modules.items())}}
print(json.dumps(mods))
"""


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_run_loads_no_jax(name):
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), name=name, over=CELLS[name])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {m.split(".")[0] for m in mods} & FORBIDDEN
    bench_dir = str(ROOT / "benchmarks")
    assert not [m for m, f in mods.items() if f and f.startswith(bench_dir)]
    assert "repro_torch" in mods  # the program is what ran


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN
    assert "benchmarks" not in tops
    if "reference" in path.parts or "work" in path.parts:
        assert "repro_torch" not in tops


def test_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import bench.reference.forest, bench.reference.trainer, bench.reference.binning\n"
            "import bench.reference.forestgen, bench.work.counts, bench.work.peaks\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "repro_torch" not in tops and not tops & FORBIDDEN
