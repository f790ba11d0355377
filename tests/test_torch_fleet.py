"""The port's fleet (registry, table dedup, router, fleet CLI) against the
JAX package's, on the CPU.

The counterparts of ``tests/test_fleet.py`` run on the port with
``device="cpu"``, over one module-scoped directory of artifacts written by
the JAX package (the shared-format contract: three same-ladder v3 bundles,
a v2 exact one, a legacy v1 npz and a different-model swap target; one JAX
training configuration).  Then the places where the two packages must
agree on the same directory (plus a JAX ``.toadpack`` of the ladder's first
rung): the manifest, the pool's stats and the memory report number for
number, the admission log, ``verify_fleet``'s codes, routed scores against
JAX's ``predict_raw``, early-exit labels and the dry run's report.  Last,
what only the port has: the pool's tensors on the device (one
``data_ptr()`` per shared table), ``auto`` on a card model, and the fleet
CLI's refusal to pass when a fallback served."""

import argparse
import dataclasses
import json
import logging
import shutil

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.fleet as jfleet
from repro.analysis import verify_fleet as jax_verify_fleet
from repro.api.model import _FOREST_FIELDS

from repro_torch.analysis import verify_fleet
from repro_torch.api import (
    ArtifactError,
    EarlyExitPolicy,
    EngineStats,
    ResiliencePolicy,
    ToadModel,
    load_checked,
)
from repro_torch.api import backends
from repro_torch.fleet import FleetEngine, ModelRegistry, UnknownModelError
from repro_torch.launch.fleet import serve_fleet

ATOL = 1e-5
CPU = "cpu"


def _train(seed=0, flip=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    if flip:
        y = (X[:, 2] - X[:, 0] > 0).astype(np.float32)
    else:
        y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    m = japi.ToadModel(task="binary", n_bins=32, n_rounds=12, max_depth=3).fit(X, y)
    return m, X


@pytest.fixture(scope="module")
def fleet_dir(tmp_path_factory):
    """JAX-written artifacts: ``d`` is ``tests/test_fleet.py``'s mixed fleet
    (three same-ladder v3, one v2 exact, one legacy v1 npz, a swap target);
    ``dm`` holds ``d``'s fleet without the swap target plus a JAX
    ``.toadpack`` of the first rung (a streaming entry of the ladder)."""
    d = tmp_path_factory.mktemp("fleet")
    m, X = _train()
    JS = japi.CompressionSpec
    m.compress(spec=JS.codebook_full(6, 4))
    m.save(str(d / "cb_a.toad"))
    m.compress(spec=JS.codebook_full(6, 2))
    m.save(str(d / "cb_b.toad"))
    m.compress(spec=JS.thr_codebook(6))
    m.save(str(d / "cb_c.toad"))
    m.compress(spec=JS.exact())
    m.save(str(d / "exact_v2.toad"))

    # legacy v1: a pre-versioning npz without format_version / spec / fingerprint
    arrays = {f: np.asarray(getattr(m.forest, f)) for f in _FOREST_FIELDS}
    cfg = dataclasses.asdict(m.config)
    cfg.pop("hist_quant_bits")
    meta = {"config": cfg, "n_bins": m.n_bins,
            "n_ensembles": m.forest.n_ensembles, "compressed": True}
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    arrays["toad_stream"] = m.encoded.data
    arrays["toad_stream_bits"] = np.asarray(m.encoded.n_bits, np.int64)
    with open(d / "legacy_v1.npz", "wb") as f:
        np.savez_compressed(f, **arrays)

    m2, _ = _train(seed=9, flip=True)
    m2.compress(spec=JS.fp16_leaves())
    m2.save(str(d / "swap_target.toad"))

    dm = tmp_path_factory.mktemp("mixed")
    for p in d.iterdir():
        if p.name != "swap_target.toad":
            shutil.copy(p, dm / p.name)
    m.compress(spec=JS.codebook_full(6, 4))
    japi.save_streaming(m, str(dm / "pk_a.toadpack"))
    return d, X, dm


def _flip_byte(src, dst):
    with np.load(src) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    arrays["toad_stream"] = arrays["toad_stream"][:-3]
    with open(dst, "wb") as f:
        np.savez_compressed(f, **arrays)
    return str(dst)


# ----------------------------------------------------------- load_checked
def test_load_checked_is_the_shared_admission_path(fleet_dir):
    d, _, _ = fleet_dir
    loaded = load_checked(str(d / "cb_a.toad"), device=CPU)
    assert loaded.format_version == 3
    assert loaded.model.is_compressed
    assert not [x for x in loaded.diagnostics if x.severity == "error"]
    legacy = load_checked(str(d / "legacy_v1.npz"), device=CPU)
    assert legacy.format_version == 1
    v2 = load_checked(str(d / "exact_v2.toad"), device=CPU)
    assert v2.format_version == 2


def test_load_checked_refuses_malformed(fleet_dir, tmp_path):
    d, _, _ = fleet_dir
    bad = _flip_byte(d / "cb_a.toad", tmp_path / "bad.toad")
    with pytest.raises(ArtifactError, match="structural verification"):
        load_checked(bad, device=CPU)
    reg = ModelRegistry(device=CPU)
    with pytest.raises(ArtifactError):
        reg.register("bad", bad)
    assert len(reg) == 0  # failed admission leaves the fleet untouched


# --------------------------------------------------------------- registry
def test_mixed_version_fleet_serves_side_by_side(fleet_dir):
    d, X, _ = fleet_dir
    reg = ModelRegistry.from_dir(str(d), device=CPU)
    # every artifact in the dir admitted, incl. the v1 legacy bundle
    assert "legacy_v1" in reg and "exact_v2" in reg and "cb_a" in reg
    versions = {mid: reg.get(mid).format_version for mid in reg.ids()}
    assert versions["legacy_v1"] == 1
    assert versions["exact_v2"] == 2
    assert versions["cb_a"] == 3
    with FleetEngine(reg, max_batch=32) as eng:
        for mid in reg.ids():
            got = eng.predict(mid, X[:64])
            ref = reg.get(mid).model.predict(X[:64], backend="reference")
            np.testing.assert_allclose(got, ref, rtol=ATOL, atol=ATOL)


def test_registry_rejects_duplicate_and_unknown(fleet_dir):
    d, _, _ = fleet_dir
    reg = ModelRegistry(device=CPU)
    reg.register("m", str(d / "cb_a.toad"))
    with pytest.raises(ValueError, match="already registered"):
        reg.register("m", str(d / "cb_b.toad"))
    with pytest.raises(UnknownModelError, match="fleet hosts: m"):
        reg.get("nope")
    with pytest.raises(UnknownModelError):
        reg.swap("nope", str(d / "cb_b.toad"))


def test_registry_and_engine_default_to_the_card(fleet_dir):
    d, _, _ = fleet_dir
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRegistry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRegistry.from_dir(str(d))


# ------------------------------------------------------------------ dedup
def test_dedup_interns_same_ladder_tables(fleet_dir):
    d, _, _ = fleet_dir
    reg = ModelRegistry(device=CPU)
    a = reg.register("a", str(d / "cb_a.toad"))
    b = reg.register("b", str(d / "cb_b.toad"))
    c = reg.register("c", str(d / "cb_c.toad"))
    # same ladder -> identical thresholds -> one resident table object
    assert a.model.packed.thr_table is b.model.packed.thr_table
    assert b.model.packed.thr_table is c.model.packed.thr_table
    assert a.thr_codebook_table is b.thr_codebook_table
    # the decoded twin points at the same interned array
    assert a.model.decoded.thr_table is a.model.packed.thr_table
    # leaf tables differ across rungs (different leaf codebook bits)
    assert a.model.packed.leaf_values is not b.model.packed.leaf_values
    assert reg.pool.refs(a.model.packed.thr_table) == 3


def test_dedup_shares_one_device_tensor_per_table(fleet_dir):
    """The port's half of dedup: the kernels read ``DevicePacked``, so the
    same-ladder models' device tables are one tensor (one ``data_ptr()``),
    installed before any predictor captured its own copy."""
    d, X, _ = fleet_dir
    reg = ModelRegistry(device=CPU)
    entries = [reg.register(k, str(d / f"{k}.toad"))
               for k in ("cb_a", "cb_b", "cb_c", "exact_v2")]
    dps = [e.model.device_packed() for e in entries]
    assert len({dp.thr_table.data_ptr() for dp in dps[:3]}) == 1
    # the device tensors are shared exactly where the host arrays are
    want = 0
    for name in ("thr_table", "leaf_values"):
        groups: dict = {}  # id of the interned host array -> [array, ptrs, holders]
        for e, dp in zip(entries, dps):
            host = getattr(e.model.packed, name)
            g = groups.setdefault(id(host), [host, set(), 0])
            g[1].add(getattr(dp, name).data_ptr())
            g[2] += 1
        assert all(len(ptrs) == 1 for _, ptrs, _ in groups.values())
        assert len({p for _, ptrs, _ in groups.values() for p in ptrs}) == len(groups)
        want += sum((n - 1) * host.nbytes for host, _, n in groups.values())
    thr = entries[0].model.packed.thr_table
    assert reg.pool.on_device(thr, CPU) is dps[0].thr_table
    reg.pool.release_device(thr, CPU)
    assert reg.pool.device_refs(thr, CPU) == sum(
        e.model.packed.thr_table is thr for e in entries) >= 3
    # the served predictors read those tensors and keep their scores
    with FleetEngine(reg, max_batch=32) as eng:
        for e in entries:
            got = eng.predict(e.model_id, X[:32])
            assert e.model.device_packed().thr_table.data_ptr() in (
                dps[0].thr_table.data_ptr(), dps[3].thr_table.data_ptr())
            np.testing.assert_allclose(
                got, e.model.predict(X[:32], backend="reference"), rtol=ATOL, atol=ATOL)
    # per shared tensor, (holders - 1) copies saved
    assert reg.pool.device_stats()[CPU]["dedup_saved_bytes"] == want > 0


def test_streaming_entry_scores_from_the_pools_leaf_tensor(fleet_dir):
    d, X, dm = fleet_dir
    reg = ModelRegistry(device=CPU)
    pk = reg.register("pk", str(dm / "pk_a.toadpack"))
    cb = reg.register("cb", str(dm / "cb_a.toad"))
    leaf = reg.pool.on_device(pk.model.header.leaf_values, CPU)
    reg.pool.release_device(pk.model.header.leaf_values, CPU)
    assert pk.model.scorer._leaf_values is leaf
    assert cb.model.device_packed().leaf_values is leaf
    assert reg.pool.device_refs(pk.model.header.leaf_values, CPU) == 2
    got = pk.model.predict(X[:32])
    np.testing.assert_allclose(got, cb.model.predict(X[:32], backend="reference"),
                               rtol=ATOL, atol=ATOL)


def test_fleet_memory_report_shared_lt_standalone(fleet_dir):
    """A 3-model same-ladder fleet is strictly smaller resident than the sum
    of standalone per-model bytes."""
    d, _, _ = fleet_dir
    reg = ModelRegistry(device=CPU)
    for mid, name in [("a", "cb_a.toad"), ("b", "cb_b.toad"), ("c", "cb_c.toad")]:
        reg.register(mid, str(d / name))
    rep = reg.memory_report()
    assert rep["n_models"] == 3
    assert rep["fleet_resident_bytes"] < rep["standalone_total_bytes"]
    assert rep["dedup_saved_bytes"] > 0
    assert rep["n_shared_tables"] >= 1
    for row in rep["models"].values():
        # per-model rows carry both accounting bases
        assert row["resident"]["total_bytes"] > 0
        assert abs(
            row["sections"]["total_bytes"]
            - sum(v for k, v in row["sections"].items() if k != "total_bytes")
        ) < 1e-6
        assert row["shared_bytes"] > 0  # all three share the thr table


def test_pool_release_on_swap_and_remove(fleet_dir):
    d, _, _ = fleet_dir
    reg = ModelRegistry(device=CPU)
    a = reg.register("a", str(d / "cb_a.toad"))
    reg.register("b", str(d / "cb_b.toad"))
    thr = a.model.packed.thr_table
    old_tensor = a.model.device_packed().thr_table
    assert reg.pool.refs(thr) == 2 and reg.pool.device_refs(thr, CPU) == 2
    reg.swap("a", str(d / "swap_target.toad"))  # different ladder
    assert reg.pool.refs(thr) == 1  # old entry released, b still holds it
    assert reg.pool.device_refs(thr, CPU) == 1
    reg.remove("b")
    assert reg.pool.refs(thr) == 0 and reg.pool.device_refs(thr, CPU) == 0
    assert reg.pool.device_stats() == {
        CPU: {"n_tensors": 2, "n_shared_tensors": 0, "saved_copies": 0,
              "tensor_bytes": float(sum(t.nbytes for t in
                                        reg.get("a").interned.arrays[:2])),
              "dedup_saved_bytes": 0.0}}
    # a retired backend keeps its own reference: the old tensor stays valid
    assert old_tensor.numel() == thr.size


# --------------------------------------------------------------- hot-swap
def test_hot_swap_under_concurrent_submits(fleet_dir):
    d, X, _ = fleet_dir
    reg = ModelRegistry(device=CPU)
    old = reg.register("m", str(d / "cb_a.toad"))
    new_path = str(d / "swap_target.toad")
    old_ref = old.model.predict(X[:64], backend="reference")

    with FleetEngine(reg, max_batch=16, max_wait_ms=1.0) as eng:
        eng.warm("m")
        futs_old = [eng.submit("m", X[i]) for i in range(64)]
        entry = eng.swap("m", new_path)  # mid-traffic version bump
        futs_new = [eng.submit("m", X[i]) for i in range(64)]
        got_old = np.stack([f.result(timeout=30) for f in futs_old])
        got_new = np.stack([f.result(timeout=30) for f in futs_new])
        eng.drain()

    assert entry.version == 2 and eng.registry.get("m").version == 2
    new_ref = entry.model.predict(X[:64], backend="reference")
    # old-version futures completed against the old model, new requests hit
    # the new version — and the two models genuinely disagree
    np.testing.assert_allclose(got_old, old_ref, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got_new, new_ref, rtol=ATOL, atol=ATOL)
    assert float(np.abs(old_ref - new_ref).max()) > 1e-4

    stats = eng.stats()
    assert stats.n_retired >= 1  # the drained old-version backend
    assert stats.fleet.n_requests == 128


def test_swap_failure_leaves_old_version_serving(fleet_dir, tmp_path):
    d, _, _ = fleet_dir
    reg = ModelRegistry(device=CPU)
    reg.register("m", str(d / "cb_a.toad"))
    bad = _flip_byte(d / "cb_b.toad", tmp_path / "bad_swap.toad")
    with pytest.raises(ArtifactError):
        reg.swap("m", bad)
    entry = reg.get("m")
    assert entry.version == 1 and entry.path.endswith("cb_a.toad")


# ----------------------------------------------------------------- engine
def test_router_rejects_unknown_model_id(fleet_dir):
    d, X, _ = fleet_dir
    reg = ModelRegistry(device=CPU)
    reg.register("m", str(d / "cb_a.toad"))
    with FleetEngine(reg) as eng:
        with pytest.raises(UnknownModelError, match="unknown model_id"):
            eng.submit("ghost", X[0])
        with pytest.raises(UnknownModelError):
            eng.predict("ghost", X[:4])


def test_lru_eviction_keeps_serving(fleet_dir):
    d, X, _ = fleet_dir
    reg = ModelRegistry.from_dir(str(d), device=CPU)
    ids = [i for i in reg.ids() if i != "swap_target"][:3]
    with FleetEngine(reg, max_hot=1, max_batch=16) as eng:
        for _ in range(2):  # revisits re-warm evicted models
            for mid in ids:
                got = eng.predict(mid, X[:16])
                ref = reg.get(mid).model.predict(X[:16], backend="reference")
                np.testing.assert_allclose(got, ref, rtol=ATOL, atol=ATOL)
        eng.drain()
        assert eng.stats().n_hot == 1


# ------------------------------------------------------------ EngineStats
def test_engine_stats_queue_depth_and_occupancy(fleet_dir):
    d, X, _ = fleet_dir
    reg = ModelRegistry(device=CPU)
    reg.register("m", str(d / "cb_a.toad"))
    with FleetEngine(reg, max_batch=16, max_wait_ms=1.0) as eng:
        futs = [eng.submit("m", X[i]) for i in range(48)]
        [f.result(timeout=30) for f in futs]
        s = eng.stats().per_model["m"]
    keys = set(s.as_dict())
    assert {"n_requests", "n_batches", "wall_s", "req_per_s", "mean_batch",
            "latency_mean_ms", "latency_p50_ms", "latency_p95_ms"} <= keys
    assert s.queue_depth == 0  # drained
    assert s.batch_occupancy  # at least one bucket was hit
    total = sum(o["batches"] for o in s.batch_occupancy.values())
    assert total == s.n_batches
    for bucket, o in s.batch_occupancy.items():
        assert 0.0 < o["mean_fill"] <= 1.0
        assert bucket >= 1


def test_engine_stats_merge():
    a = EngineStats(10, 2, 1.0, 10.0, 5.0, 1.0, 1.0, 2.0,
                    queue_depth=1, batch_occupancy={8: {"batches": 2, "mean_fill": 0.5}})
    b = EngineStats(30, 3, 2.0, 15.0, 10.0, 3.0, 3.0, 6.0,
                    queue_depth=2, batch_occupancy={8: {"batches": 3, "mean_fill": 1.0}})
    m = EngineStats.merge([a, b])
    assert m.n_requests == 40 and m.n_batches == 5
    assert m.wall_s == 2.0 and m.queue_depth == 3
    assert abs(m.latency_mean_ms - (10 * 1.0 + 30 * 3.0) / 40) < 1e-9
    occ = m.batch_occupancy[8]
    assert occ["batches"] == 5
    assert abs(occ["mean_fill"] - (2 * 0.5 + 3 * 1.0) / 5) < 1e-9
    empty = EngineStats.merge([])
    assert empty.n_requests == 0


# -------------------------------------------------------------------- CLI
def _ns(d, **kw):
    base = dict(models=str(d), dry_run=False, smoke=True, requests=64, clients=2,
                backend=None, device=CPU, max_hot=8, max_batch=32, max_wait_ms=1.0)
    base.update(kw)
    return argparse.Namespace(**base)


def test_serve_fleet_smoke_with_swap(fleet_dir):
    d, _, _ = fleet_dir
    out = serve_fleet(_ns(d, swap=[f"cb_a={d / 'swap_target.toad'}"]))
    assert out["max_err"] <= ATOL
    assert out["swapped"] == {"cb_a": 2}
    assert out["memory"]["fleet_resident_bytes"] < out["memory"]["standalone_total_bytes"]
    assert out["stats"]["fleet"]["n_fallback_batches"] == 0


def test_serve_fleet_dry_run(fleet_dir):
    d, _, _ = fleet_dir
    report = serve_fleet(argparse.Namespace(models=str(d), dry_run=True, smoke=True,
                                            device=CPU))
    assert report["n_models"] == 6
    assert report["fleet_resident_bytes"] <= report["standalone_total_bytes"]


def test_serve_gbdt_smoke_uses_fingerprint_probe(fleet_dir, monkeypatch):
    """--model smoke traffic comes from the artifact's own fingerprint probe
    set, not an independent random batch."""
    import repro_torch.core.pipeline as pipeline
    from repro_torch.launch.serve import serve_gbdt

    d, _, _ = fleet_dir
    path = str(d / "cb_a.toad")
    fp = ToadModel.load(path, device=CPU).artifact_meta["fingerprint"]
    seen = {}
    real = pipeline.probe_inputs

    def spy(forest, n=64, seed=0):
        seen["n"], seen["seed"] = n, seed
        return real(forest, n=n, seed=seed)

    monkeypatch.setattr(pipeline, "probe_inputs", spy)
    ns = argparse.Namespace(arch="toad-gbdt", backend="reference", model=path,
                            device=CPU, requests=64, clients=2, max_batch=32,
                            max_wait_ms=1.0, smoke=True, early_exit=None,
                            scores_out=None)
    serve_gbdt(ns)
    assert seen["n"] == fp["n_probe"] and seen["seed"] == fp["seed"]


def test_serve_cli_dispatches_toad_fleet(fleet_dir, capsys):
    from repro_torch.launch import serve

    d, _, _ = fleet_dir
    out = serve.main(["--arch", "toad-fleet", "--models", str(d), "--device", CPU,
                      "--smoke", "--max-batch", "32", "--max-wait-ms", "1"])
    assert out["max_err"] <= ATOL and out["n_served"] == 256
    assert "served 256 routed requests across 6 models" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "toad-fleet", "--device", CPU, "--smoke"])


def test_fleet_cli_refuses_a_corrupted_directory_naming_the_file(fleet_dir, tmp_path):
    from repro_torch.launch import fleet

    d, _, _ = fleet_dir
    bad = tmp_path / "bad"
    shutil.copytree(d, bad)
    _flip_byte(d / "cb_b.toad", bad / "cb_b.toad")
    with pytest.raises(SystemExit, match="fleet admission refused") as e:
        fleet.main(["--models", str(bad), "--device", CPU, "--dry-run"])
    assert "cb_b.toad" in str(e.value) and "cb_a.toad" not in str(e.value)


def test_fleet_cli_fails_when_a_fallback_served(fleet_dir, tmp_path, monkeypatch):
    """The CLI injects no fault, so a batch that a fallback served means a
    primary failed: the run exits non-zero though the fallback's scores
    pass parity."""
    from repro_torch.launch import fleet

    d, _, _ = fleet_dir
    real = ToadModel.predictor

    def predictor(self, backend=None):
        fn = real(self, backend)
        if backend != "packed":
            return fn

        def faulty(X):  # passes the zero warm-up rows, fails real ones
            if bool(torch.as_tensor(X).any()):
                raise RuntimeError("primary down")
            return fn(X)

        return faulty

    monkeypatch.setattr(ToadModel, "predictor", predictor)
    spec = tmp_path / "p.json"
    spec.write_text(ResiliencePolicy(fallback=True).to_json())
    with pytest.raises(SystemExit, match="served by a fallback"):
        fleet.main(["--models", str(d), "--device", CPU, "--smoke",
                    "--backend", "packed", "--resilience", str(spec)])


@pytest.mark.parametrize("hopper", [True, False])
def test_auto_on_a_card_model_is_cuda_or_an_error(fleet_dir, monkeypatch, hopper):
    """``auto`` never resolves to ``packed`` for a model on a card: the
    fleet's primary is the kernel's backend or the route raises."""
    d, _, _ = fleet_dir
    reg = ModelRegistry(device=CPU)
    entry = reg.register("m", str(d / "cb_a.toad"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0) if hopper else (8, 0))
    entry.model.device = torch.device("cuda", 0)  # as if admitted on a card
    eng = FleetEngine(reg)  # not started: nothing runs on the card
    if hopper:
        eng.warm("m")
        assert eng._hot["m"].engine._chain[0][0] == "cuda"
    else:
        with pytest.raises(RuntimeError, match="sm_90a"):
            eng.warm("m")
        assert eng.stats().n_hot == 0
    assert backends.resolve_backend(None, compressed=True, device=CPU).name == "packed"


# ---------------------------------------------------- the JAX package's
def _without_ms(lines):
    return [line.rsplit(" in ", 1)[0] for line in lines]


def _admit_log(caplog, logger, build):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        reg = build()
    return reg, [r.getMessage() for r in caplog.records
                 if r.name == logger and "admitted" in r.getMessage()]


@pytest.fixture(scope="module")
def both(fleet_dir):
    """The port's and the JAX package's registries over the mixed dir."""
    _, _, dm = fleet_dir
    return (ModelRegistry.from_dir(str(dm), device=CPU),
            jfleet.ModelRegistry.from_dir(str(dm)))


def test_manifest_equals_jax_row_for_row(both):
    port, jax = both
    pm, jm = port.manifest(), jax.manifest()
    assert list(pm["models"]) == list(jm["models"])
    for mid in jm["models"]:
        prow, jrow = dict(pm["models"][mid]), dict(jm["models"][mid])
        # a streaming row's first-prediction time is a clock reading, and
        # its scorer's backend is the port's device traversal (``packed``)
        # where the JAX package's is its host ``reference``
        for row, backend in ((prow, "packed"), (jrow, "reference")):
            if "streaming" in row:
                assert row["streaming"]["backend"] == backend
                row["streaming"] = {k: v for k, v in row["streaming"].items()
                                    if k not in ("time_to_first_prediction_ms",
                                                 "backend")}
        assert prow == jrow, mid
    assert pm["dedup"] == jm["dedup"]
    assert pm["n_models"] == jm["n_models"] == 6
    assert port.pool.stats() == jax.pool.stats()


def test_memory_report_equals_jax_number_for_number(both):
    port, jax = both
    pr, jr = port.memory_report(), jax.memory_report()
    assert pr == jr
    assert pr["dedup_saved_bytes"] > 0
    assert pr["models"]["pk_a"]["shared_bytes"] > 0  # pack shares with cb_a


def test_admission_log_equals_jax(fleet_dir, caplog):
    _, _, dm = fleet_dir
    _, plog = _admit_log(caplog, "repro_torch.fleet.registry",
                         lambda: ModelRegistry.from_dir(str(dm), device=CPU))
    _, jlog = _admit_log(caplog, "repro.fleet.registry",
                         lambda: jfleet.ModelRegistry.from_dir(str(dm)))
    assert len(plog) == 6 and _without_ms(plog) == _without_ms(jlog)
    assert all(line.endswith(" ms") for line in plog)
    assert "streaming" in plog[-1]  # pk_a sorts last


def test_verify_fleet_codes_equal_jax(fleet_dir, tmp_path):
    d, _, _ = fleet_dir
    bad = _flip_byte(d / "cb_b.toad", tmp_path / "cb_b.toad")
    paths = [str(d / "cb_a.toad"), bad, str(d / "legacy_v1.npz")]
    pv, jv = verify_fleet(paths), jax_verify_fleet(paths)
    assert list(pv) == list(jv) == paths
    codes = lambda v: {p: sorted((x.code, x.severity) for x in diags)
                       for p, diags in v.items()}
    assert codes(pv) == codes(jv)
    assert any(sev == "error" for _, sev in codes(pv)[bad])
    with pytest.raises(ArtifactError, match="1 of 6 artifact"):
        ModelRegistry.from_dir(str(_bad_dir(d, bad, tmp_path)), device=CPU)


def _bad_dir(d, bad, tmp_path):
    out = tmp_path / "dir"
    shutil.copytree(d, out)
    shutil.copy(bad, out / "cb_b.toad")
    return out


def test_routed_scores_equal_jax_predict_raw(both, fleet_dir):
    _, X, _ = fleet_dir
    port, jax = both
    with FleetEngine(port, max_batch=32, max_wait_ms=1.0) as eng:
        futs = {mid: [eng.submit(mid, x) for x in X[:48]] for mid in port.ids()}
        got = {mid: np.stack([f.result(timeout=30) for f in fs])
               for mid, fs in futs.items()}
    for mid, scores in got.items():
        ref = jax.get(mid).model.predict(X[:48], backend="reference")
        np.testing.assert_allclose(scores, ref, rtol=ATOL, atol=ATOL, err_msg=mid)


def test_early_exit_labels_equal_jax(both, fleet_dir):
    _, X, _ = fleet_dir
    port, jax = both
    eng = FleetEngine(port, max_batch=64, early_exit=EarlyExitPolicy(epsilon=0.0))
    with eng:
        got = {mid: eng.predict(mid, X) for mid in port.ids()}
    s = eng.stats()
    assert 0 < s.fleet.mean_trees_evaluated < 12  # some rows exited early
    for mid, scores in got.items():
        labels = (scores[:, 0] > 0).astype(np.int32)
        full = jax.get(mid).model.predict(X, backend="reference")
        np.testing.assert_array_equal(labels, (full[:, 0] > 0).astype(np.int32),
                                      err_msg=mid)


def test_dry_run_report_equals_jax(fleet_dir):
    from repro.launch.fleet import serve_fleet as jax_serve_fleet

    d, _, _ = fleet_dir
    ns = lambda: argparse.Namespace(models=str(d), dry_run=True, smoke=True, device=CPU)
    assert serve_fleet(ns()) == jax_serve_fleet(ns())
