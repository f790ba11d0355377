"""Cross-model codebook dedup: content-addressed interning of value tables,
on the host and on the device.

The port's copy of ``repro.fleet.dedup``.  The paper's compression story
compounds at fleet scale only if models actually *share* their resident
tables.  Models compressed from the same budget ladder (one trained forest,
different ``CompressionSpec`` rungs) carry byte-identical fp32 threshold
tables — the ``threshold_codebook`` stage derives the table from the exact
forest, so two rungs that differ only in leaf bits snap to the same
thresholds.  :class:`TablePool` interns those tables by content hash so each
distinct table is resident once per fleet process, and
:func:`fleet_memory_report` extends the per-model ``core.memory`` accounting
(``stream_sections`` on the wire, ``packed_resident_bytes`` in memory) with
the per-model vs shared split.

Host interning is the JAX package's, key for key and count for count: the
packed serving form's ``thr_table`` / ``leaf_values`` (and their decoded
twins) become the pool's read-only canonical arrays, and so does the
format-3 threshold codebook table.  The port's kernels do not read those
host arrays: they read a :class:`~repro_torch.kernels.ops.DevicePacked`, a
copy on the model's device.  So the pool also keeps, per device, one tensor
of each interned table, and :func:`intern_model_tables` builds the model's
``DevicePacked`` around the pool's tensors before any predictor exists
(a backend's closure captures the ``DevicePacked`` it was built with):
same-ladder models hand B1 and B3 one ``data_ptr()`` per shared table.  A
streaming entry's scorer resolves leaf refs against the pool's tensor too
(:func:`intern_streaming_tables`).  Releasing the last entry of a table
drops the pool's host array and tensors; a retired backend keeps its own
reference through its closure, so draining requests stay valid.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading

import numpy as np
import torch

from repro_torch.core.memory import packed_resident_bytes, stream_sections

#: the packed serving form's value tables a fleet shares (host and device)
SHARED_TABLES = ("thr_table", "leaf_values")


def table_key(arr: np.ndarray) -> tuple:
    """Content-hash key of a table: (dtype, shape, sha256 of the bytes)."""
    a = np.ascontiguousarray(np.asarray(arr))
    return (a.dtype.str, a.shape, hashlib.sha256(a.tobytes()).hexdigest())


class TablePool:
    """Content-addressed intern pool for fleet-shared value tables.

    ``intern(arr)`` returns the canonical (read-only) array for ``arr``'s
    content — the same object for every byte-identical table, so N models
    from one ladder keep one resident copy.  Reference counts track how
    many live registry entries point at each table; ``release`` drops a
    reference and frees the table when the last owner is swapped out.

    ``on_device(arr, device)`` returns the pool's one tensor of an interned
    table's content on ``device`` and counts the caller as one of its
    holders; ``release_device`` drops that count and frees the tensor at
    zero.  :meth:`device_stats` is the device side of :meth:`stats`.
    """

    def __init__(self):
        self._tables: dict[tuple, np.ndarray] = {}
        self._refs: dict[tuple, int] = {}
        #: (key, device) -> [tensor, holders]
        self._device: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def intern(self, arr: np.ndarray) -> np.ndarray:
        key = table_key(arr)
        with self._lock:
            hit = self._tables.get(key)
            if hit is None:
                hit = np.ascontiguousarray(np.asarray(arr))
                hit.setflags(write=False)  # shared: nobody may mutate it
                self._tables[key] = hit
                self._refs[key] = 0
            self._refs[key] += 1
            return hit

    def release(self, arr: np.ndarray) -> None:
        key = table_key(arr)
        with self._lock:
            if key not in self._refs:
                return
            self._refs[key] -= 1
            if self._refs[key] <= 0:
                del self._refs[key]
                del self._tables[key]
                for dk in [dk for dk in self._device if dk[0] == key]:
                    del self._device[dk]

    def refs(self, arr: np.ndarray) -> int:
        """Live reference count of ``arr``'s content (0 if not interned)."""
        with self._lock:
            return self._refs.get(table_key(arr), 0)

    def on_device(self, arr: np.ndarray, device) -> torch.Tensor:
        """The pool's tensor of interned ``arr``'s content on ``device``,
        copied there at its first request; the caller becomes a holder."""
        key = table_key(arr)
        dk = (key, str(torch.device(device)))
        with self._lock:
            if key not in self._tables:
                raise KeyError("on_device() of a table that is not interned")
            slot = self._device.get(dk)
            if slot is None:
                # a writable host copy: the canonical array is read-only
                host = np.array(self._tables[key])
                slot = self._device[dk] = [torch.from_numpy(host).to(device), 0]
            slot[1] += 1
            return slot[0]

    def release_device(self, arr: np.ndarray, device) -> None:
        dk = (table_key(arr), str(torch.device(device)))
        with self._lock:
            slot = self._device.get(dk)
            if slot is None:
                return
            slot[1] -= 1
            if slot[1] <= 0:
                del self._device[dk]

    def device_refs(self, arr: np.ndarray, device) -> int:
        """Holders of ``arr``'s tensor on ``device`` (0 if there is none)."""
        dk = (table_key(arr), str(torch.device(device)))
        with self._lock:
            slot = self._device.get(dk)
            return slot[1] if slot is not None else 0

    def stats(self) -> dict:
        """Unique/duplicate byte accounting over everything interned."""
        with self._lock:
            unique_bytes = 0.0
            shared_bytes = 0.0
            saved = 0.0
            n_shared = 0
            for key, table in self._tables.items():
                refs = self._refs[key]
                unique_bytes += table.nbytes
                if refs > 1:
                    n_shared += 1
                    shared_bytes += table.nbytes
                    saved += (refs - 1) * table.nbytes
            return {
                "n_tables": len(self._tables),
                "n_shared_tables": n_shared,
                "unique_table_bytes": float(unique_bytes),
                "shared_table_bytes": float(shared_bytes),
                "dedup_saved_bytes": float(saved),
            }

    def device_stats(self) -> dict:
        """Per device: its tensors, how many are shared, their bytes, the
        copies the sharing spares (``holders - 1`` summed) and their bytes
        (tensor bytes, before any allocator rounding)."""
        out: dict = {}
        with self._lock:
            for (_, dev), (t, holders) in self._device.items():
                nbytes = t.numel() * t.element_size()
                s = out.setdefault(dev, {"n_tensors": 0, "n_shared_tensors": 0,
                                         "tensor_bytes": 0.0, "saved_copies": 0,
                                         "dedup_saved_bytes": 0.0})
                s["n_tensors"] += 1
                s["tensor_bytes"] += float(nbytes)
                if holders > 1:
                    s["n_shared_tensors"] += 1
                    s["saved_copies"] += holders - 1
                    s["dedup_saved_bytes"] += float((holders - 1) * nbytes)
        return out


@dataclasses.dataclass
class InternedTables:
    """The tables a registry entry holds in the pool (released on swap):
    host arrays, and ``(array, device)`` pairs of the tensors it holds."""

    arrays: list
    device_tables: list = dataclasses.field(default_factory=list)

    def release_all(self, pool: TablePool) -> None:
        for a, dev in self.device_tables:
            pool.release_device(a, dev)
        for a in self.arrays:
            pool.release(a)
        self.arrays = []
        self.device_tables = []


def intern_model_tables(model, pool: TablePool):
    """Intern a loaded model's shareable tables into ``pool``.

    Replaces ``model.packed.thr_table`` / ``.leaf_values`` (and the decoded
    twins) with the pool's canonical arrays, and interns the format-3
    threshold-codebook table itself (the distinct sorted threshold values
    the stream's per-feature refs resolve against).  On the model's device
    the two tables become the pool's tensors: the model serves from a
    ``DevicePacked`` built around them (``ToadModel.use_device_packed``),
    which every backend built afterwards reads.  Returns
    ``(interned, thr_codebook_table)`` — ``thr_codebook_table`` is ``None``
    for classic (non-codebook) streams.
    """
    from repro_torch.core.layout import used_threshold_values
    from repro_torch.kernels.ops import to_device

    interned = InternedTables(arrays=[])
    packed, decoded = model.packed, model.decoded
    on_device = {}
    for name in SHARED_TABLES:
        shared = pool.intern(getattr(packed, name))
        interned.arrays.append(shared)
        setattr(packed, name, shared)
        if decoded is not None:
            setattr(decoded, name, shared)
        on_device[name] = pool.on_device(shared, model.device)
        interned.device_tables.append((shared, model.device))
    model.use_device_packed(to_device(packed, model.device, tables=on_device))
    cb_table = None
    if model.encoded is not None and model.encoded.thr_codebook_bits > 0:
        cb_table = pool.intern(used_threshold_values(model.forest))
        interned.arrays.append(cb_table)
    return interned, cb_table


def intern_streaming_tables(model, pool: TablePool):
    """Intern a streaming (``ProgressiveModel``) entry's header tables.

    A ``.toadpack`` fronts its threshold/leaf tables in the stream header,
    so they are fully resident the moment the model is admitted — before
    any tree block has landed — and dedup against classic entries works
    because the header tables are byte-identical to the packed serving
    form's (both decode the same stream sections).  The scorer's leaf table
    on the device becomes the pool's tensor (its blocks carry their own
    per-node thresholds, so no threshold table lives there).  Same return
    shape as :func:`intern_model_tables`.
    """
    interned = InternedTables(arrays=[])
    header = model.header
    for name in SHARED_TABLES:
        shared = pool.intern(getattr(header, name))
        interned.arrays.append(shared)
        setattr(header, name, shared)
    model.scorer.use_leaf_values(pool.on_device(header.leaf_values, model.device))
    interned.device_tables.append((header.leaf_values, model.device))
    cb_table = None
    if header.cb_table is not None:
        cb_table = pool.intern(header.cb_table)
        interned.arrays.append(cb_table)
        header.cb_table = cb_table
    return interned, cb_table


def fleet_memory_report(registry) -> dict:
    """Per-model vs shared resident-byte accounting for a whole fleet.

    Extends the single-model ``core.memory`` accounting: each entry reports
    its on-the-wire ``stream_sections`` and in-memory
    ``packed_resident_bytes`` as if it were standalone, plus
    ``shared_bytes`` — the bytes of its tables that are interned with at
    least one other model.  Fleet-wide::

        fleet_resident_bytes = standalone_total_bytes - dedup_saved_bytes

    so a 3-model same-ladder fleet reports strictly fewer resident bytes
    than three standalone processes would.  Host accounting, the JAX
    package's number for number; the device side is
    ``registry.pool.device_stats()``.
    """
    pool = registry.pool
    models: dict[str, dict] = {}
    standalone_total = 0.0
    for entry in registry.entries():
        model = entry.model
        cb_bytes = (
            float(entry.thr_codebook_table.nbytes)
            if entry.thr_codebook_table is not None
            else 0.0
        )
        if getattr(model, "is_streaming_model", False):
            # streaming entries account their decoded blocks + header
            # tables; on-the-wire sections come from the pack manifest
            resident = model.resident_bytes()
            man = model.manifest
            sections = {
                "header_bytes": float(man["header"]["n_bytes"]),
                "tree_blocks_bytes": float(
                    sum(b["n_bytes"] for b in man["blocks"])),
                "fingerprint_bytes": float(man["fingerprint"]["n_bytes"]),
            }
            sections["total_bytes"] = float(sum(sections.values()))
            standalone = resident["total_bytes"]
        else:
            resident = packed_resident_bytes(model.packed)
            cb_bits = (
                model.encoded.thr_codebook_bits
                if model.encoded is not None else 0
            )
            sections = stream_sections(model.forest,
                                       thr_codebook_bits=cb_bits)
            standalone = resident["total_bytes"] + cb_bytes
        shared = sum(
            float(np.asarray(a).nbytes)
            for a in entry.interned.arrays
            if pool.refs(a) > 1
        )
        models[entry.model_id] = {
            "version": entry.version,
            "format_version": entry.format_version,
            "standalone_bytes": standalone,
            "shared_bytes": float(shared),
            "thr_codebook_table_bytes": cb_bytes,
            "resident": resident,
            "sections": sections,
        }
        standalone_total += standalone
    pool_stats = pool.stats()
    return {
        "n_models": len(models),
        "models": models,
        "standalone_total_bytes": float(standalone_total),
        "fleet_resident_bytes": float(
            standalone_total - pool_stats["dedup_saved_bytes"]
        ),
        **pool_stats,
    }
