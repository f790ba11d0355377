"""The port's ToaD stream against the JAX package's: for forests that
``repro`` trained and for the synthetic full-shape forest at reduced size,
``encode`` gives identical bytes (classic and threshold-codebook layouts),
and decode / to_packed / from_packed / stream_offsets / the memory
accounting give equal results.  bitio round-trips and fails the same way."""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.bitio as jbitio
import repro.core.layout as jlayout
import repro.core.memory as jmemory
from repro.api import ToadModel as JaxToadModel
from repro.gbdt.forest import Forest as JaxForest

import repro_torch.core.bitio as tbitio
import repro_torch.core.layout as tlayout
import repro_torch.core.memory as tmemory
from repro_torch.gbdt.forest import FOREST_FIELDS, forest_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import synthetic_forest  # noqa: E402

# the JAX trainer's configurations (shared with the other test_torch_* files)
BINARY = dict(task="binary", n_rounds=12, max_depth=3, learning_rate=0.3)
PENALISED = dict(BINARY, toad_penalty_feature=1.0, toad_penalty_threshold=0.5)
MULTICLASS = dict(PENALISED, task="multiclass", n_classes=3, n_rounds=6)


def _xy(seed, task, int_features=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    if int_features:
        X = np.abs(np.round(X * 3)).astype(np.float32)
    if task == "binary":
        y = (X[:, 0] + X[:, 1] ** 2 > 0.7).astype(np.float32)
    else:
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    return X, y


def _fit(cfg, seed, int_features=False):
    X, y = _xy(seed, cfg["task"], int_features)
    return JaxToadModel(n_bins=16, **cfg).fit(X, y).forest


def _jax_forest(arrays, n_ensembles=1):
    return JaxForest(**{f: jnp.asarray(arrays[f]) for f in FOREST_FIELDS},
                     n_ensembles=n_ensembles)


def _port(forest):
    arrays = {f: np.asarray(getattr(forest, f)) for f in FOREST_FIELDS}
    return forest_from_numpy(arrays, forest.n_ensembles, device="cpu")


@pytest.fixture(scope="module")
def forests():
    synthetic = synthetic_forest(
        5, n_trees=20, max_depth=5, n_features=24, n_bins=32, n_used_features=8,
        max_thr_per_feature=6, n_leaf_values=50)
    return {
        "binary": _fit(BINARY, 0),
        "binary-int-features": _fit(BINARY, 1, int_features=True),
        "penalised": _fit(PENALISED, 2),
        "multiclass3": _fit(MULTICLASS, 3),
        "synthetic": _jax_forest(synthetic),
        "zero-split": _jax_forest(synthetic_forest(6, n_trees=4, max_depth=3,
                                                   n_features=5, n_bins=8,
                                                   n_used_features=0)),
    }


NAMES = ["binary", "binary-int-features", "penalised", "multiclass3",
         "synthetic", "zero-split"]


def _assert_same_fields(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("cb_bits", [0, 6])
@pytest.mark.parametrize("name", NAMES)
def test_encode_bytes_identical(forests, name, cb_bits):
    jf = forests[name]
    want = jlayout.encode(jf, thr_codebook_bits=cb_bits)
    got = tlayout.encode(_port(jf), thr_codebook_bits=cb_bits)
    assert got.n_bits == want.n_bits
    assert got.thr_codebook_bits == want.thr_codebook_bits
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == np.uint8


@pytest.mark.parametrize("cb_bits", [0, 6])
@pytest.mark.parametrize("name", NAMES)
def test_decode_pack_and_offsets_equal(forests, name, cb_bits):
    enc = jlayout.encode(forests[name], thr_codebook_bits=cb_bits)
    port_enc = tlayout.EncodedModel(enc.data, enc.n_bits, enc.thr_codebook_bits)
    _assert_same_fields(tlayout.decode(port_enc), jlayout.decode(enc))
    _assert_same_fields(tlayout.to_packed(tlayout.decode(port_enc)),
                        jlayout.to_packed(jlayout.decode(enc)))
    got, want = tlayout.stream_offsets(port_enc), jlayout.stream_offsets(enc)
    assert got.header == want.header
    assert got.sections == want.sections
    mid = (got.sections["trees"][0] + got.sections["trees"][1]) // 2
    assert got.section_at(mid) == want.section_at(mid) == "trees"


@pytest.mark.parametrize("name", NAMES)
def test_from_packed_roundtrips(forests, name):
    dec = tlayout.decode(tlayout.encode(_port(forests[name])))
    packed = tlayout.to_packed(dec)
    back = tlayout.from_packed(packed)
    _assert_same_fields(tlayout.to_packed(back), packed)
    _assert_same_fields(back, jlayout.from_packed(jlayout.to_packed(
        jlayout.decode(jlayout.encode(forests[name])))))
    x = np.random.default_rng(0).normal(size=(40, dec.n_features)).astype(np.float32)
    np.testing.assert_array_equal(back.predict(x), dec.predict(x))


@pytest.mark.parametrize("name", NAMES)
def test_memory_accounting_equal(forests, name):
    jf = forests[name]
    tf = _port(jf)
    assert tmemory.toad_bits_host(tf) == jmemory.toad_bits_host(jf)
    for cb_bits in (0, 6):
        assert tmemory.stream_sections(tf, cb_bits) == jmemory.stream_sections(jf, cb_bits)
    assert tmemory.compression_summary(tf) == jmemory.compression_summary(jf)
    assert tmemory.reuse_factor(tf) == jmemory.reuse_factor(jf)
    packed = tlayout.to_packed(tlayout.decode(tlayout.encode(tf)))
    assert tmemory.packed_resident_bytes(packed) == jmemory.packed_resident_bytes(
        jlayout.to_packed(jlayout.decode(jlayout.encode(jf))))
    np.testing.assert_array_equal(tlayout.used_threshold_values(tf),
                                  jlayout.used_threshold_values(jf))


@pytest.mark.parametrize("values", [
    [0.0, 1.0, 3.0], [0.5, 2.0], [1e-3, 7.25], [0.1, 1e5], [300.0, 70000.0],
])
def test_select_width_equal(values):
    assert tlayout.select_width(np.asarray(values)) == \
        jlayout.select_width(np.asarray(values))


def _fields(seed, n=200):
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, 40, size=n)
    values = [int(rng.integers(0, 1 << int(w))) if w else 0 for w in widths]
    return list(zip(values, widths.tolist()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitio_roundtrip_identical(seed):
    fields = _fields(seed)
    writers = (jbitio.BitWriter(), tbitio.BitWriter())
    for w in writers:
        for v, width in fields:
            w.write(v, width)
        w.write_f32(-1.5)
        w.write_f16(0.25)
    assert writers[0].n_bits == writers[1].n_bits
    data = writers[1].getvalue()
    np.testing.assert_array_equal(data, writers[0].getvalue())
    r = tbitio.BitReader(data, writers[1].n_bits)
    assert [r.read(width) for _, width in fields] == [v for v, _ in fields]
    assert (r.read_f32(), r.read_f16()) == (-1.5, 0.25)
    assert r.remaining == 0
    # bulk reads agree with the JAX reader
    a, b = tbitio.BitReader(data), jbitio.BitReader(data)
    np.testing.assert_array_equal(a.read_array(7, 20), b.read_array(7, 20))
    assert [tbitio.bits_for(n) for n in range(70)] == [jbitio.bits_for(n) for n in range(70)]


def _error(make, mod):
    try:
        make(mod)
    except mod.StreamBoundsError as exc:
        return type(exc).__name__, str(exc), exc.pos, exc.width
    except ValueError as exc:
        return type(exc).__name__, str(exc)
    raise AssertionError("no error raised")


@pytest.mark.parametrize("case", [
    "read-past-end", "array-past-end", "declared-too-long", "seek-outside",
    "subreader-outside", "subreader-read-past-window", "value-too-wide",
])
def test_bitio_bounds_errors_equal(case):
    data = np.asarray([0xA5, 0x3C], np.uint8)

    def make(mod):
        r = mod.BitReader(data, 13)
        if case == "read-past-end":
            r.read(10)
            r.read(4)
        elif case == "array-past-end":
            r.read_array(5, 3)
        elif case == "declared-too-long":
            mod.BitReader(data, 17)
        elif case == "seek-outside":
            r.seek(14)
        elif case == "subreader-outside":
            r.subreader(8, 6)
        elif case == "subreader-read-past-window":
            sub = r.subreader(3, 6)
            assert sub.pos == 3
            sub.read(7)
        elif case == "value-too-wide":
            mod.BitWriter().write(8, 3)

    assert _error(make, tbitio) == _error(make, jbitio)
