"""The port's streaming slice against the JAX package's, on the CPU.

The counterparts of ``tests/test_stream.py`` that need no fleet (the
``.toadpack`` v4 container, progressive scoring, tree orders, v1-v3
fallback, the TOAD11x refusals, background feeding, toadcheck on packs;
its fleet tests are in ``tests/test_torch_fleet_chaos.py``), run on the port with ``device="cpu"``; then the places where the two
packages must agree: ``write_pack``'s bytes, packs crossing between them,
the per-block partial sums, the refusal codes on the same corrupted files,
``feed_until_confident`` and ``predict_early_exit(tree_order=...)``.

The JAX package fits each model once (module fixtures); the port compresses
the same exact forest with the same spec, which gives the JAX package's
stream, and writes its own packs."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.stream as jstream
from repro.analysis import verify_pack as jax_verify_pack
from repro.api.model import _FOREST_FIELDS
from repro.gbdt.early_exit import EarlyExitPolicy as JaxPolicy
from repro.gbdt.early_exit import predict_early_exit as jax_predict_early_exit

from repro_torch.analysis import errors, verify_pack
from repro_torch.api import (
    ArtifactError,
    CompressionSpec,
    ToadModel,
    load_checked,
    save_streaming,
)
from repro_torch.fleet import ModelRegistry
from repro_torch.gbdt import GBDTConfig, forest_from_numpy
from repro_torch.gbdt.early_exit import EarlyExitPolicy, predict_early_exit
from repro_torch.stream import (
    PACK_MAGIC,
    TREE_BLOCK,
    BlockReader,
    ProgressiveModel,
    ProgressiveScorer,
    StreamingError,
    open_streaming,
    read_manifest,
    tree_order_most_informative,
    write_pack,
)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
TASKS = (("binary", 0), ("multiclass", 3))


def _data(task, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    if task == "binary":
        y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    else:
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    return X, y


def _port_twin(jm, spec):
    """The port's model on the JAX model's exact forest, compressed by the
    same spec (so its stream is the JAX package's)."""
    arrays = {f: np.asarray(getattr(jm.forest_exact, f)) for f in _FOREST_FIELDS}
    forest = forest_from_numpy(arrays, jm.forest.n_ensembles, device="cpu")
    pm = ToadModel.from_forest(forest, config=GBDTConfig(**dataclasses.asdict(jm.config)),
                               n_bins=jm.n_bins, device="cpu")
    return pm.compress(spec=spec)


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """task -> (port model, JAX model, X, port .toad, port .toadpack, JAX
    .toadpack): binary and 3-class, codebook-compressed."""
    root = tmp_path_factory.mktemp("stream")
    out = {}
    for task, n_classes in TASKS:
        X, y = _data(task)
        jm = japi.ToadModel(task=task, n_classes=n_classes, n_bins=16, n_rounds=12,
                            max_depth=3, learning_rate=0.3).fit(X, y)
        jm = jm.compress(spec=japi.CompressionSpec.codebook_full(6, 4))
        pm = _port_twin(jm, CompressionSpec.codebook_full(6, 4))
        toad, pack, jpack = (str(root / f"{task}{s}") for s in
                             (".toad", ".toadpack", "_jax.toadpack"))
        pm.save(toad)
        save_streaming(pm, pack)
        japi.save_streaming(jm, jpack)
        out[task] = (pm, jm, X, toad, pack, jpack)
    return out


def _ref(pm, X):
    return pm.predict(X, backend="reference")


# ------------------------------------------------------------- container
def test_pack_is_magic_tagged_and_manifest_parses(packs):
    pack = packs["binary"][4]
    assert Path(pack).read_bytes()[:8] == PACK_MAGIC
    man = read_manifest(pack)
    assert man["format_version"] == 4
    assert man["tree_block"] == TREE_BLOCK
    assert man["n_blocks"] == len(man["blocks"])
    # blocks tile the permuted stream contiguously
    assert sum(b["n_trees"] for b in man["blocks"]) == man["n_trees"]


def test_default_tree_order_is_most_informative_first(packs):
    pm, _, _, _, pack, _ = packs["binary"]
    man = read_manifest(pack)
    expect = tree_order_most_informative(pm.forest)
    assert man["tree_order"] == [int(t) for t in expect]
    assert sorted(man["tree_order"]) == list(range(man["n_trees"]))


def test_verify_pack_deep_is_clean(packs):
    for task, _ in TASKS:
        diags = verify_pack(packs[task][4], deep=True)
        assert not errors(diags), [d.code for d in diags]


@pytest.mark.parametrize("order", ["default", "permuted"])
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_write_pack_writes_the_jax_bytes(packs, tmp_path, task, order):
    """For the same forest and tree order, the port writes the JAX
    package's file: manifest, header, every block, every digest."""
    pm, jm, _, _, _, _ = packs[task]
    kw = {}
    if order == "permuted":
        kw["tree_order"] = np.random.default_rng(3).permutation(int(pm.forest.n_trees))
    a = write_pack(pm, str(tmp_path / "port.toadpack"), **kw)
    b = jstream.write_pack(jm, str(tmp_path / "jax.toadpack"), **kw)
    assert Path(a).read_bytes() == Path(b).read_bytes()


@pytest.mark.parametrize("tree_block", [1, 2])
def test_pack_offsets_settle_where_two_passes_do_not(tmp_path, tree_block):
    """The manifest's offsets are fixed up until the manifest's length
    settles.  A 44-tree forest in one-tree blocks has an offset that gains
    a digit on the second pass: the JAX package's two passes then write
    every offset short and its own verify_pack refuses the pack (TOAD111),
    where the port's pack is clean and differs only in those offsets.  In
    two-tree blocks two passes settle, and the bytes are equal."""
    import jax.numpy as jnp
    from repro.gbdt.forest import Forest as JaxForest
    from repro.gbdt.trainer import GBDTConfig as JaxConfig

    sys.path.insert(0, str(ROOT))
    from chip_smoke import synthetic_forest

    arrays = synthetic_forest(1, n_trees=44, max_depth=4, n_features=16, n_bins=32,
                              n_used_features=8, max_thr_per_feature=8,
                              n_leaf_values=64)
    cfg = JaxConfig(task="binary", n_rounds=44, max_depth=4)
    jm = japi.ToadModel.from_forest(
        JaxForest(**{k: jnp.asarray(arrays[k]) for k in _FOREST_FIELDS}, n_ensembles=1),
        cfg, n_bins=32)
    pm = ToadModel.from_forest(forest_from_numpy(arrays, 1, device="cpu"),
                               GBDTConfig(**dataclasses.asdict(cfg)), n_bins=32,
                               device="cpu")
    a = write_pack(pm, str(tmp_path / "port.toadpack"), tree_block=tree_block)
    b = jstream.write_pack(jm, str(tmp_path / "jax.toadpack"), tree_block=tree_block)
    assert not errors(verify_pack(a, deep=True))
    jax_codes = {d.code for d in errors(jax_verify_pack(b, deep=False))}
    pa, pb = Path(a).read_bytes(), Path(b).read_bytes()
    if tree_block == 2:
        assert not jax_codes and pa == pb
        return
    assert jax_codes == {"TOAD111"}
    ma, mb = read_manifest(a), read_manifest(b)
    # every JAX offset is short by the same bytes: the digits it gained
    shifts = {ea["offset"] - eb["offset"] for ea, eb in zip(
        [ma["header"], ma["fingerprint"], *ma["blocks"]],
        [mb["header"], mb["fingerprint"], *mb["blocks"]])}
    assert len(shifts) == 1 and shifts.pop() > 0
    for m in (ma, mb):
        for entry in [m["header"], m["fingerprint"], *m["blocks"]]:
            del entry["offset"]
    assert ma == mb
    # the payload after the manifest is the same bytes
    assert pa[read_manifest_end(pa):] == pb[read_manifest_end(pb):]


def read_manifest_end(raw: bytes) -> int:
    """Byte offset where a pack's payload starts (prelude + manifest)."""
    return 20 + int.from_bytes(raw[12:20], "little")


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("backend", ["reference", "packed"])
def test_progressive_converges_to_classic(packs, task, backend):
    pm, _, X, _, pack, _ = packs[task]
    sm = open_streaming(pack, device="cpu")
    assert sm.is_streaming and sm.format_version == 4
    scorer = sm.scorer(backend=backend)
    seen_blocks = []
    while scorer.feed_next():
        res = scorer.predict(X[:64], backend=backend)
        seen_blocks.append(res.blocks_evaluated)
        assert res.scores.shape == (64, max(1, int(pm.forest.n_ensembles)))
        assert res.score_is_final == (res.blocks_evaluated == res.n_blocks)
    assert seen_blocks == sorted(seen_blocks)  # monotone refinement
    final = scorer.predict(X[:64], backend=backend)
    assert final.score_is_final
    np.testing.assert_allclose(final.scores, _ref(pm, X[:64]), rtol=ATOL, atol=ATOL)


def test_any_permutation_converges(packs, tmp_path):
    pm, jm, X, _, _, _ = packs["multiclass"]
    order = np.random.default_rng(3).permutation(int(pm.forest.n_trees))
    pack = str(tmp_path / "perm.toadpack")
    write_pack(pm, pack, tree_order=order)
    sm = open_streaming(pack, device="cpu")
    assert read_manifest(pack)["tree_order"] == [int(t) for t in order]
    scorer = sm.scorer()
    scorer.feed_all()
    got = scorer.predict(X[:64]).scores
    np.testing.assert_allclose(got, _ref(pm, X[:64]), rtol=ATOL, atol=ATOL)
    # and within 1e-5 of the JAX model's predict_raw, on both backends
    want = np.asarray(jm.predict(X[:64], backend="reference"))
    for backend in ("reference", "packed"):
        np.testing.assert_allclose(scorer.predict(X[:64], backend=backend).scores,
                                   want, rtol=ATOL, atol=ATOL, err_msg=backend)


def test_first_block_answers_and_stats(packs):
    _, _, X, _, pack, _ = packs["binary"]
    sm = open_streaming(pack, device="cpu")
    scorer = sm.scorer()
    scorer.feed_next()
    res = scorer.predict(X[:8])
    assert res.blocks_evaluated == 1
    assert res.trees_evaluated == min(TREE_BLOCK, int(sm.n_trees))
    assert not res.score_is_final or res.n_blocks == 1
    st = scorer.stats()
    assert st["time_to_first_prediction_ms"] is not None
    assert st["blocks_evaluated"] == 1


def test_streaming_model_full_predict_matches_classic(packs):
    _, _, X, toad, pack, _ = packs["binary"]
    got = open_streaming(pack, device="cpu").predict(X[:64])
    ref = load_checked(toad, device="cpu").model.predict(X[:64], backend="reference")
    np.testing.assert_allclose(got, ref, rtol=ATOL, atol=ATOL)


def test_scorer_rejects_classic_bundles(packs):
    toad = packs["binary"][3]
    sm = open_streaming(toad, device="cpu")
    assert not sm.is_streaming
    with pytest.raises(ValueError):
        ProgressiveScorer(sm)


# ------------------------------------------------- the default backend
def _default_sums_land_on(sm, X, monkeypatch):
    """Score ``X`` through every streaming entry point with no backend
    named; returns the (device, dtype) of each partial-sum tensor the
    scorer brought back to the host.  The host numpy traversal is made to
    fail, so a default that fell back to it would raise."""
    from repro_torch.stream import progressive

    def no_host_walk(*_):
        raise AssertionError("the default backend walked the trees on the host")

    seen = []

    def host(t):
        seen.append((t.device.type, t.dtype))
        return t.cpu().numpy()

    monkeypatch.setattr(progressive, "_block_values_np", no_host_walk)
    monkeypatch.setattr(progressive, "host", host)
    scorer = sm.scorer()
    assert scorer.backend == "packed"
    outs = [scorer.feed_all().predict(X).scores, sm.predict(X),
            ProgressiveModel(sm, background=False).predict(X)]
    for block in scorer._blocks:
        assert block.on_device.feature.device.type == sm.device.type
    return outs, seen


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_default_backend_scores_on_the_models_device(packs, task, monkeypatch):
    """With no backend named, the scorer, ``StreamingModel.predict`` and
    ``ProgressiveModel.predict`` walk the trees on the model's device and
    keep the float64 sums there: ``reference`` runs only when asked for."""
    pm, _, X, _, pack, _ = packs[task]
    sm = open_streaming(pack, device="cpu")
    outs, seen = _default_sums_land_on(sm, X[:64], monkeypatch)
    assert seen == [("cpu", torch.float64)] * 3
    for got in outs:
        np.testing.assert_allclose(got, _ref(pm, X[:64]), rtol=ATOL, atol=ATOL)


@pytest.mark.gpu
def test_default_scorer_keeps_its_sums_on_the_card(packs, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    pm, _, X, _, pack, _ = packs["multiclass"]
    sm = open_streaming(pack, device="cuda")
    outs, seen = _default_sums_land_on(sm, X[:64], monkeypatch)
    assert seen == [("cuda", torch.float64)] * 3
    for got in outs:
        np.testing.assert_allclose(got, _ref(pm, X[:64]), rtol=ATOL, atol=ATOL)


# ---------------------------------------------------- the two packages
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_packs_open_and_stream_in_the_other_package(packs, task, direction):
    pm, jm, X, _, pack, jpack = packs[task]
    want = np.asarray(jm.predict(X[:64], backend="reference"))
    if direction == "jax->port":
        sm = open_streaming(jpack, device="cpu")
        assert not [d for d in sm.diagnostics if d.severity == "error"]
        got = sm.scorer(backend="packed").feed_all().predict(X[:64]).scores
    else:
        assert not errors(jax_verify_pack(pack, deep=True))
        got = jstream.open_streaming(pack).scorer().feed_all().predict(X[:64]).scores
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["reference", "packed"])
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_partial_sums_match_jax_block_by_block(packs, task, backend):
    _, _, X, _, pack, jpack = packs[task]
    mine = open_streaming(pack, device="cpu").scorer(backend=backend)
    theirs = jstream.open_streaming(jpack).scorer(backend=backend)
    n = 0
    while mine.feed_next():
        assert theirs.feed_next()
        a, b = mine.predict(X[:64]), theirs.predict(X[:64])
        assert (a.blocks_evaluated, a.trees_evaluated, a.score_is_final) == \
            (b.blocks_evaluated, b.trees_evaluated, b.score_is_final)
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-6, atol=1e-6)
        n += 1
    assert n == mine.n_blocks > 1 and not theirs.feed_next()


# --------------------------------------------------- v1-v3 fallback parity
def test_v1_v2_v3_fallback_serves_identically(packs, tmp_path):
    pm, jm, X, _, _, _ = packs["binary"]
    paths = {3: str(tmp_path / "v3.toad")}
    pm.save(paths[3])  # threshold codebook
    m2 = _port_twin(jm, CompressionSpec.exact())
    paths[2] = str(tmp_path / "v2.toad")
    m2.save(paths[2])
    # legacy v1: an npz without format_version / spec / fingerprint
    arrays = {f: np.asarray(getattr(m2.forest, f)) for f in _FOREST_FIELDS}
    cfg = dataclasses.asdict(m2.config)
    cfg.pop("hist_quant_bits")
    meta = {"config": cfg, "n_bins": m2.n_bins,
            "n_ensembles": m2.forest.n_ensembles, "compressed": True}
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    arrays["toad_stream"] = m2.encoded.data
    arrays["toad_stream_bits"] = np.asarray(m2.encoded.n_bits, np.int64)
    paths[1] = str(tmp_path / "v1.npz")
    with open(paths[1], "wb") as f:
        np.savez_compressed(f, **arrays)

    for version, path in paths.items():
        sm = open_streaming(path, device="cpu")
        assert not sm.is_streaming
        assert sm.format_version == version
        ref = load_checked(path, device="cpu").model.predict(X[:64], backend="reference")
        for backend in ("reference", "packed"):
            got = sm.predict(X[:64], backend=backend)
            np.testing.assert_allclose(got, ref, rtol=ATOL, atol=ATOL,
                                       err_msg=f"v{version}/{backend}")


# --------------------------------------------------------- TOAD11x refusals
def _corrupt_block(src, dst, block=1):
    """Flip one payload byte inside tree block ``block``."""
    man = read_manifest(src)
    raw = bytearray(Path(src).read_bytes())
    off = man["blocks"][block]["offset"]
    raw[off] ^= 0xFF
    Path(dst).write_bytes(bytes(raw))
    return str(dst)


def _tamper_order(src, dst):
    """Duplicate one single-digit tree_order entry over another, so the
    manifest keeps its byte length (offsets stay valid)."""
    raw = Path(src).read_bytes()
    mlen = int.from_bytes(raw[12:20], "little")
    man = json.loads(raw[20:20 + mlen])
    order = man["tree_order"]
    singles = [i for i, t in enumerate(order) if 0 <= t <= 9]
    man["tree_order"] = list(order)
    man["tree_order"][singles[0]] = order[singles[1]]
    doc = json.dumps(man).encode("utf-8")
    assert len(doc) == mlen
    Path(dst).write_bytes(raw[:20] + doc + raw[20 + mlen:])
    return str(dst)


def test_corrupted_block_refused_with_TOAD111(packs, tmp_path):
    pack = packs["binary"][4]
    bad = _corrupt_block(pack, tmp_path / "bad.toadpack")
    diags = verify_pack(bad, deep=True)
    assert "TOAD111" in {d.code for d in errors(diags)}
    # lazy path: admission (header-only) succeeds, the poisoned block is
    # refused the moment the reader consumes it
    sm = open_streaming(bad, device="cpu")
    scorer = sm.scorer()
    assert scorer.feed_next()  # block 0 is intact
    with pytest.raises(StreamingError, match="TOAD111"):
        scorer.feed_all()
    # eager admission refuses too: load_checked, and the fleet registry's
    # non-background admission, which leaves the fleet empty
    with pytest.raises(ArtifactError, match="TOAD111"):
        load_checked(bad, device="cpu")
    reg = ModelRegistry(device="cpu")
    with pytest.raises(ArtifactError, match="TOAD111"):
        reg.register("bad", bad)
    assert len(reg) == 0


def test_truncated_pack_refused_with_TOAD112(packs, tmp_path):
    raw = Path(packs["binary"][4]).read_bytes()
    bad = tmp_path / "trunc.toadpack"
    bad.write_bytes(raw[:-16])  # rips through the fingerprint section
    diags = verify_pack(str(bad), deep=False)
    assert "TOAD112" in {d.code for d in errors(diags)}
    with pytest.raises(StreamingError, match="TOAD11"):
        open_streaming(str(bad), device="cpu")


def test_tampered_tree_order_refused_with_TOAD113(packs, tmp_path):
    bad = _tamper_order(packs["binary"][4], tmp_path / "order.toadpack")
    diags = verify_pack(bad, deep=False)
    assert "TOAD113" in {d.code for d in errors(diags)}
    with pytest.raises(StreamingError, match="TOAD113"):
        open_streaming(bad, device="cpu")


def _header_trees_lie(src, dst):
    """Rewrite the header's 16-bit tree count (after the 8-bit class count)
    so it disagrees with the manifest; the header digest then fails too."""
    man = read_manifest(src)
    raw = bytearray(Path(src).read_bytes())
    off = man["header"]["offset"]
    raw[off + 1] ^= 0x01
    Path(dst).write_bytes(bytes(raw))
    return str(dst)


CORRUPTIONS = {
    "not-a-pack": lambda src, dst: (Path(dst).write_bytes(b"TOADPACK" + bytes(16)), str(dst))[1],
    "missing-key": lambda src, dst: _drop_key(src, dst),
    "flipped-block": _corrupt_block,
    "flipped-fingerprint": lambda src, dst: _flip_at(src, dst, "fingerprint"),
    "truncated": lambda src, dst: (Path(dst).write_bytes(Path(src).read_bytes()[:-16]), str(dst))[1],
    "tampered-order": _tamper_order,
    "header-trees": _header_trees_lie,
}


def _drop_key(src, dst):
    raw = Path(src).read_bytes()
    mlen = int.from_bytes(raw[12:20], "little")
    man = json.loads(raw[20:20 + mlen])
    del man["stream_sha256"]
    doc = json.dumps(man).encode("utf-8")
    Path(dst).write_bytes(raw[:12] + len(doc).to_bytes(8, "little") + doc
                          + raw[20 + mlen:])
    return str(dst)


def _flip_at(src, dst, section):
    man = read_manifest(src)
    raw = bytearray(Path(src).read_bytes())
    raw[man[section]["offset"]] ^= 0xFF
    Path(dst).write_bytes(bytes(raw))
    return str(dst)


def _codes(fn):
    try:
        fn()
    except Exception as e:  # the refusal's codes, in the message
        return type(e).__name__, sorted(set(
            w[:7] for w in str(e).replace(":", " ").split() if w.startswith("TOAD1")))
    return "ok", []


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_refusal_codes_equal_jax(packs, tmp_path, kind):
    bad = CORRUPTIONS[kind](packs["binary"][4], tmp_path / f"{kind}.toadpack")
    for deep in (False, True):
        mine = [(d.code, d.severity, d.section) for d in verify_pack(bad, deep=deep)]
        theirs = [(d.code, d.severity, d.section) for d in jax_verify_pack(bad, deep=deep)]
        assert mine == theirs, (deep, mine, theirs)
    assert errors(verify_pack(bad, deep=True))  # the deep pass refuses it
    for verify in (True, False):
        if kind == "not-a-pack" and not verify:
            continue  # nothing to read unverified
        got = _codes(lambda: open_streaming(bad, verify=verify, device="cpu").scorer().feed_all())
        want = _codes(lambda: jstream.open_streaming(bad, verify=verify).scorer().feed_all())
        assert got[1] == want[1], (verify, got, want)
    if kind == "header-trees":
        assert _codes(lambda: open_streaming(bad, verify=False, device="cpu"))[1] == ["TOAD114"]


def test_load_checked_on_a_pack_behaves_as_jax(packs, tmp_path):
    """Toadcheck first: a corrupted pack is refused with its code; a clean
    one passes toadcheck and then fails the npz load exactly as in the JAX
    package (packs are opened through ``open_streaming``)."""
    from repro.api.artifact import load_checked as jax_load_checked

    pack = packs["binary"][4]
    bad = _corrupt_block(pack, tmp_path / "bad.toadpack")
    for path in (pack, bad):
        got = _codes(lambda: load_checked(path, device="cpu"))
        want = _codes(lambda: jax_load_checked(path))
        assert got == want and got[0] != "ok"


def test_save_streaming_verifies_what_it_wrote(packs, tmp_path):
    pm = packs["binary"][0]
    out = str(tmp_path / "ok.toadpack")
    save_streaming(pm, out)
    assert not errors(verify_pack(out, deep=True))


def test_save_streaming_refuses_a_malformed_pack(packs, tmp_path, monkeypatch):
    import repro_torch.stream.format as fmt

    real = fmt.write_pack

    def write_then_corrupt(model, path, **kw):
        real(model, path, **kw)
        _corrupt_block(path, path)

    monkeypatch.setattr(fmt, "write_pack", write_then_corrupt)
    with pytest.raises(ArtifactError, match="TOAD111"):
        save_streaming(packs["binary"][0], str(tmp_path / "bad.toadpack"))


# ------------------------------------------------------------- early exit
@pytest.mark.parametrize("epsilon", [0.0, 0.5])
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_feed_until_confident_matches_jax(packs, task, epsilon):
    pm, _, X, _, pack, jpack = packs[task]
    got = open_streaming(pack, device="cpu").scorer(backend="packed") \
        .feed_until_confident(X[:64], EarlyExitPolicy(epsilon))
    want = jstream.open_streaming(jpack).scorer() \
        .feed_until_confident(X[:64], JaxPolicy(epsilon))
    assert (got.exit_reason, got.blocks_evaluated, got.trees_evaluated,
            got.decision_is_final) == (want.exit_reason, want.blocks_evaluated,
                                       want.trees_evaluated, want.decision_is_final)
    label = (np.argmax if task == "multiclass" else (lambda s, axis: s[:, 0] > 0))
    np.testing.assert_array_equal(label(got.scores, axis=1), label(want.scores, axis=1))
    np.testing.assert_array_equal(label(got.scores, axis=1),
                                  label(_ref(pm, X[:64]), axis=1))


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_predict_early_exit_tree_order_matches_jax(packs, task):
    pm, jm, X, _, _, _ = packs[task]
    order = np.random.default_rng(5).permutation(int(pm.forest.n_trees))
    for check_every in (1, TREE_BLOCK):
        got = predict_early_exit(pm.forest, X, EarlyExitPolicy(0.0),
                                 tree_order=order, check_every=check_every)
        want = jax_predict_early_exit(jm.forest, X, JaxPolicy(0.0),
                                      tree_order=order, check_every=check_every)
        np.testing.assert_array_equal(got.trees_evaluated, want.trees_evaluated)
        np.testing.assert_array_equal(got.exited, want.exited)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6, atol=1e-6)
        C = int(pm.forest.n_ensembles)
        lab = (lambda s: np.argmax(s, axis=1)) if C > 1 else (lambda s: s[:, 0] > 0)
        np.testing.assert_array_equal(lab(got.scores), lab(_ref(pm, X)))
    # the default order is the original one
    a = predict_early_exit(pm.forest, X, EarlyExitPolicy(0.0))
    b = predict_early_exit(pm.forest, X, EarlyExitPolicy(0.0),
                           tree_order=np.arange(int(pm.forest.n_trees)))
    np.testing.assert_array_equal(a.trees_evaluated, b.trees_evaluated)


# ------------------------------------------------------------ background
def test_background_feeding_completes(packs):
    pm, _, X, _, pack, _ = packs["binary"]
    sm = open_streaming(pack, device="cpu")
    pm_stream = ProgressiveModel(sm, background=True)
    assert pm_stream.wait_complete(timeout=30)
    st = pm_stream.streaming_stats()
    assert st["blocks_evaluated"] == st["n_blocks"]
    assert st["score_is_final"]
    np.testing.assert_allclose(pm_stream.predictor("packed")(X[:16]),
                               _ref(pm, X[:16]), rtol=ATOL, atol=ATOL)
    res = pm_stream.resident_bytes()
    assert res["n_blocks_loaded"] == st["n_blocks"] and res["total_bytes"] > 0
    assert pm_stream.probe_inputs(8).shape == (8, int(pm.forest.n_features))


# -------------------------------------------------------------- toadcheck
def test_toadcheck_cli_on_packs(packs, tmp_path):
    pack = packs["binary"][4]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.launch.toadcheck"]
    ok = subprocess.run(cmd + [pack], capture_output=True, text=True,
                        cwd=str(ROOT), env=env, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    bad = _corrupt_block(pack, tmp_path / "cli_bad.toadpack")
    ko = subprocess.run(cmd + [bad], capture_output=True, text=True,
                        cwd=str(ROOT), env=env, timeout=120)
    assert ko.returncode == 1
    assert "TOAD111" in ko.stdout


def test_block_reader_resident_accounting(packs):
    pack = packs["binary"][4]
    man = read_manifest(pack)
    reader = BlockReader(pack)
    assert reader.n_blocks == man["n_blocks"]
    blob, entry = reader.block_bytes(0)
    assert len(blob) == entry["n_bytes"]
