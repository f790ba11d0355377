"""The port's slice as a whole, on the CPU: the JAX package trains and saves
a model, the port's serve CLI serves it in a subprocess and its scores agree
with the JAX package's, with and without early exit; the engine's buckets
and drain; entry points that refuse to run without a card; ``chip_smoke.py``
failing here; and the port importing neither JAX nor ``repro``."""

import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import ToadModel as JaxToadModel

from repro_torch.api import EngineStopped, GBDTEngine, MicroBatchEngine, ToadModel
from repro_torch.api import backends
from repro_torch.kernels.ops import predict_packed_model

ROOT = Path(__file__).resolve().parents[1]
# the JAX trainer's configuration (shared with the other test_torch_* files)
PENALISED = dict(task="binary", n_rounds=12, max_depth=3, learning_rate=0.3,
                 toad_penalty_feature=1.0, toad_penalty_threshold=0.5)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(args, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def _parity(stdout: str) -> float:
    """The served scores' max|Δ| to the reference backend, as the CLI prints it."""
    return float(re.search(r"parity vs reference backend: max\|Δ\| = (\S+)", stdout).group(1))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    model = JaxToadModel(n_bins=16, **PENALISED).fit(X, y).compress()
    path = str(tmp_path_factory.mktemp("serve") / "m.toad")
    model.save(path)
    return path, X


@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_serve_cli_matches_the_jax_model(artifact, tmp_path, backend):
    path, _ = artifact
    out = tmp_path / "scores.npz"
    res = _run(["-m", "repro_torch.launch.serve", "--arch", "toad-gbdt",
                "--model", path, "--smoke", "--device", "cpu",
                "--backend", backend, "--scores-out", str(out)])
    assert res.returncode == 0, res.stderr
    assert "served 256 requests" in res.stdout
    # the packed backend (auto on the CPU) sums in the Pallas kernel's 8-tree
    # block order, the reference backend tree by tree
    assert _parity(res.stdout) <= (0.0 if backend == "reference" else 1e-6)
    assert "toadcheck: ok (0 warning(s))" in res.stdout
    with np.load(out) as z:
        queries, scores = z["queries"], z["scores"]
    want = JaxToadModel.load(path).predict(queries)
    assert scores.shape == want.shape == (256, 1)
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-5)
    # the served scores are the backend's own, to the bit
    port = ToadModel.load(path, device="cpu")
    served_by = "packed" if backend == "auto" else backend
    np.testing.assert_array_equal(scores, port.predictor(served_by)(queries).numpy())


def test_serve_cli_trains_in_process_without_a_model():
    """Without --model the CLI trains the reduced workload in-process and
    serves it."""
    res = _run(["-m", "repro_torch.launch.serve", "--arch", "toad-gbdt",
                "--device", "cpu", "--smoke"])
    assert res.returncode == 0, res.stderr
    assert "training toad-gbdt on cpu (rows=4096, d=16, rounds=4, depth=3)" in res.stdout
    assert "served 256 requests" in res.stdout
    # the packed backend's block order against the reference's tree by tree
    assert _parity(res.stdout) <= 1e-6


@pytest.mark.parametrize("backend", ["packed", "reference"])
def test_serve_cli_early_exit_keeps_every_label(artifact, tmp_path, backend):
    """--early-exit 0 serves the JAX-written model through the early-exit
    kernel's plain version (packed) or the reference evaluator: labels
    equal the JAX model's."""
    path, _ = artifact
    out = tmp_path / "scores.npz"
    res = _run(["-m", "repro_torch.launch.serve", "--arch", "toad-gbdt",
                "--model", path, "--smoke", "--device", "cpu",
                "--backend", backend, "--early-exit", "0", "--scores-out", str(out)])
    assert res.returncode == 0, res.stderr
    assert "served 256 requests" in res.stdout
    assert "early-exit: trees_evaluated mean " in res.stdout
    assert "/ 12 trees (exact-label mismatches = 0)" in res.stdout
    assert "parity vs reference backend" not in res.stdout
    with np.load(out) as z:
        queries, scores = z["queries"], z["scores"]
    want = JaxToadModel.load(path).predict_label(queries)
    np.testing.assert_array_equal((scores[:, 0] > 0).astype(np.int32), want)


def test_engine_buckets_rows_and_stop_resolves_every_future(artifact):
    path, X = artifact
    engine = GBDTEngine(path, backend="packed", max_batch=8, max_wait_ms=5.0,
                        device="cpu")
    assert engine.backend == "packed"
    futs = []
    lock = threading.Lock()

    def client(lo, hi):
        mine = [engine.submit(X[i]) for i in range(lo, hi)]
        with lock:
            futs.extend(zip(range(lo, hi), mine))

    with engine:
        threads = [threading.Thread(target=client, args=(c * 25, (c + 1) * 25))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    assert all(f.done() for _, f in futs)  # stop() drained the queue
    idx = [i for i, _ in futs]
    got = np.stack([f.result() for _, f in futs])
    want = engine.model.predict(X[idx], backend="reference")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    s = engine.stats()
    assert s.n_requests == 100
    assert set(s.batch_occupancy) <= {1, 2, 4, 8}
    assert sum(o["batches"] for o in s.batch_occupancy.values()) == s.n_batches
    assert all(0 < o["mean_fill"] <= 1 for o in s.batch_occupancy.values())
    assert s.latency_p95_ms >= s.latency_p50_ms > 0
    with pytest.raises(EngineStopped):
        engine.submit(X[0])
    bad = engine.start().submit(np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="cannot shape"):
        bad.result(timeout=10)
    engine.stop()


def test_stop_drains_a_backlog():
    calls = []

    def slow(rows):
        calls.append(rows.shape[0])
        time.sleep(0.01)
        return torch.from_numpy(rows[:, :1] * 2.0)

    engine = MicroBatchEngine(slow, 3, max_batch=4, max_wait_ms=0.0,
                              device="cpu").start()
    calls.clear()  # the warm-up calls, one per bucket
    futs = [engine.submit(np.full(3, i, np.float32)) for i in range(40)]
    engine.stop()
    assert [f.result(timeout=0)[0] for f in futs] == [2.0 * i for i in range(40)]
    assert all(n in (1, 2, 4) for n in calls)


def test_entry_points_refuse_to_run_without_a_card(artifact):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device runs")
    path, X = artifact
    packed = ToadModel.load(path, device="cpu").packed
    for make in (
        lambda: ToadModel(),
        lambda: ToadModel.load(path),
        lambda: GBDTEngine(path),
        lambda: predict_packed_model(packed, X),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    res = _run(["-m", "repro_torch.launch.serve", "--arch", "toad-gbdt",
                "--model", path, "--smoke"])
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr


@pytest.mark.parametrize("hopper", [True, False])
def test_auto_backend_on_a_card_is_the_kernel_or_an_error(monkeypatch, hopper):
    monkeypatch.setattr(backends, "_hopper", lambda device: hopper)
    resolve = backends.resolve_backend
    assert resolve(None, compressed=True, device="cpu").name == "packed"
    assert resolve(None, compressed=False, device="cpu").name == "reference"
    assert resolve(None, compressed=False, device="cuda").name == "reference"
    if hopper:
        assert resolve(None, compressed=True, device="cuda").name == "cuda"
    else:  # never the plain PyTorch loop in the kernel's place
        with pytest.raises(RuntimeError, match="sm_90a"):
            resolve(None, compressed=True, device="cuda")
        assert resolve("packed", compressed=True, device="cuda").name == "packed"


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = _run([str(ROOT / "chip_smoke.py")], timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "sys.path.insert(0, sys.argv[1]); import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 24 else 0)\n"
    )
    res = _run(["-c", code, str(ROOT)])
    assert res.returncode == 0, res.stdout + res.stderr
