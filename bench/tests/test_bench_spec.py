"""``BENCHMARK.json`` against the rules of the benchmark's format, and every name in it
resolved to its file."""

import json
import re

import pytest
from bench_small import ROOT

from bench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][:2] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e and metric["layer"].strip()
        assert (ROOT / "bench" / "metrics" / f"{metric['name']}.py").is_file()
        assert callable(spec.metric_reader(metric["name"]))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    got = spec.cell(cell["name"])
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    assert got["config"]["name"] == cell["config"]
    assert spec.runner(got["traffic"]).__name__ == f"bench.core.{got['traffic']['runner']}"
    e2e = [m["name"] for m in got["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert got["per_layer"]
    for m in got["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    path = ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("bench/")
    data = json.loads(path.read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    assert callable(spec.input_kind(data).draw)
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
