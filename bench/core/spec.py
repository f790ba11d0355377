"""``BENCHMARK.json`` and the files it names, resolved by name."""

from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell(name: str, overrides: dict | None = None) -> dict:
    """The workload ``name`` with its configuration and traffic loaded, and
    the metrics it reports: ``end_to_end`` and ``per_layer`` entries of
    ``BENCHMARK.json`` that list it (or list no workloads)."""
    bench = benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {', '.join(sorted(work))}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    overrides = overrides or {}
    config = _merge(json.loads((ROOT / conf["file"]).read_text()), overrides.get("config", {}))
    traffic = _merge(json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
                     overrides.get("traffic", {}))
    listed = lambda m: name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return dict(name=name, workload=w, config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str):
    """The ``read(rec)`` function of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def input_kind(config: dict):
    """The module that draws a configuration's rows and labels:
    ``bench/inputs/<kind>.py``, named by the configuration's
    ``inputs.kind``."""
    import importlib

    return importlib.import_module(f"bench.inputs.{config['inputs']['kind']}")


def runner(traffic: dict):
    """The module that drives a traffic mix: ``bench/core/<runner>.py``."""
    import importlib

    return importlib.import_module(f"bench.core.{traffic['runner']}")
