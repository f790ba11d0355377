"""The fleet model registry: verified admission, versioning, atomic hot-swap.

The port's copy of ``repro.fleet.registry``, on a device.  A
:class:`ModelRegistry` is the source of truth for which ``.toad`` artifact
serves each ``model_id``.  Admission goes through
``repro_torch.api.artifact.load_checked`` — the same toadcheck-then-load
path as ``ToadModel.load`` and the single-model engine — so a structurally
invalid bundle never enters a fleet; the negotiated ``.toad`` format
version (1 legacy / 2 exact / 3 codebook-layout, stamped lowest-sufficient
at save time) is recorded per entry, and mixed-version fleets serve side by
side.  ``.toadpack`` v4 streaming containers admit through
``repro_torch.stream.open_streaming`` behind a
:class:`~repro_torch.stream.progressive.ProgressiveModel` — with
``streaming=True`` the entry serves from its first tree block while the
rest stream in; otherwise admission waits for every block (classic
latency, same verification).  Every model lives on the registry's
``device`` (default ``"cuda"``; ``"cpu"`` only when asked for).

Every admitted model's shareable tables are interned into the registry's
:class:`~repro_torch.fleet.dedup.TablePool`, so same-ladder models keep one
resident copy of their threshold/leaf codebook tables, on the host and on
the device.

**Hot-swap** (``swap``): the replacement artifact is fully loaded, verified
and interned *before* the registry map is touched, then the entry is
replaced atomically under the lock and its serving ``version`` bumps by
one.  A failed load leaves the old version serving.  The old entry's
tables are released from the pool (still referenced by any in-flight
backend, so draining requests stay valid); the
:class:`~repro_torch.fleet.engine.FleetEngine` notices the version bump on
the next routed request, retires the old backend with a queue drain, and
sends new traffic to the new version.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
import threading
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.api.artifact import ArtifactError, load_checked
from repro_torch.fleet.dedup import (
    InternedTables,
    TablePool,
    intern_model_tables,
    intern_streaming_tables,
)

logger = logging.getLogger("repro_torch.fleet.registry")


class UnknownModelError(KeyError):
    """Routing/lookup of a model_id the registry does not host."""

    def __init__(self, model_id: str, known):
        known = sorted(known)
        super().__init__(
            f"unknown model_id {model_id!r}; fleet hosts: "
            + (", ".join(known) if known else "(empty fleet)")
        )
        self.model_id = model_id


@dataclasses.dataclass
class ModelEntry:
    """One (model_id, version) admitted into the fleet."""

    model_id: str
    version: int            # registry serving version; bumps on every swap
    path: str
    model: object           # ToadModel or ProgressiveModel
    format_version: int     # negotiated .toad format version (1..4)
    spec_name: str | None
    thr_codebook_bits: int
    diagnostics: list       # toadcheck findings at admission (warnings only)
    thr_codebook_table: np.ndarray | None
    interned: InternedTables

    @property
    def is_streaming(self) -> bool:
        """True for ``.toadpack`` entries served progressively."""
        return bool(getattr(self.model, "is_streaming_model", False))

    def describe(self) -> dict:
        """Manifest row for this entry (what --dry-run prints)."""
        meta = (self.model.artifact_meta or {}).get("manifest", {})
        row = {
            "version": self.version,
            "path": self.path,
            "format_version": self.format_version,
            "spec": self.spec_name,
            "thr_codebook_bits": self.thr_codebook_bits,
            "n_trees": int(self.model.forest.n_trees),
            "n_features": int(self.model.forest.n_features),
            "encoded_stream_bytes": meta.get("encoded_stream_bytes"),
            "n_warnings": len(self.diagnostics),
        }
        if self.is_streaming:
            row["streaming"] = self.model.streaming_stats()
        return row


class ModelRegistry:
    """Hosts many verified ``.toad`` models behind stable model ids."""

    def __init__(
        self,
        pool: TablePool | None = None,
        verify: bool = True,
        faults=None,
        streaming: bool = False,
        device="cuda",
    ):
        self.pool = pool if pool is not None else TablePool()
        self.verify = verify
        self.streaming = streaming  # progressive .toadpack admission (opt-in)
        self.device = resolve_device(device)
        self._faults = faults  # test-only FaultPlan hook ("admit" point)
        self._entries: dict[str, ModelEntry] = {}
        self._lock = threading.RLock()

    # ------------------------------------------------------------- admission
    def _admit(self, model_id: str, path: str, version: int) -> ModelEntry:
        if self._faults is not None:
            # the injected mid-swap load error: fires before anything is
            # loaded or interned, so a failed swap() leaves the old entry
            # serving and the table pool untouched
            self._faults.fire("admit", model=model_id)
        t0 = time.perf_counter()
        from repro_torch.stream.format import is_pack  # lazy: import cycle

        if is_pack(path):
            entry = self._admit_streaming(model_id, path, version)
        else:
            entry = self._admit_classic(model_id, path, version)
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        logger.info(
            "admitted %s v%d from %s (.toad format v%d%s) in %.1f ms",
            model_id, version, os.path.basename(path), entry.format_version,
            ", streaming" if entry.is_streaming else "", elapsed_ms,
        )
        return entry

    def _admit_classic(self, model_id: str, path: str,
                       version: int) -> ModelEntry:
        loaded = load_checked(path, verify=self.verify, device=self.device)
        model = loaded.model
        if not model.is_compressed:
            # a fleet serves the packed artifact; lossless-compress in place
            model.compress()
        interned, cb_table = intern_model_tables(model, self.pool)
        return ModelEntry(
            model_id=model_id,
            version=version,
            path=loaded.path,
            model=model,
            format_version=loaded.format_version,
            spec_name=model.spec.name if model.spec is not None else None,
            thr_codebook_bits=(
                model.encoded.thr_codebook_bits
                if model.encoded is not None
                else 0
            ),
            diagnostics=loaded.diagnostics,
            thr_codebook_table=cb_table,
            interned=interned,
        )

    def _admit_streaming(self, model_id: str, path: str,
                         version: int) -> ModelEntry:
        """Admit a ``.toadpack`` behind a progressive scorer.

        With ``streaming=True`` the model serves from its first tree block
        and the rest stream in from a background feeder; otherwise every
        block is consumed before this returns (classic admission latency,
        new container).  Either way the container's manifest + header are
        verified up front and each block's sha256 is enforced as it lands.
        """
        from repro_torch.stream.progressive import ProgressiveModel
        from repro_torch.stream.reader import open_streaming

        sm = open_streaming(path, verify=self.verify, device=self.device)
        model = ProgressiveModel(sm, background=self.streaming)
        interned, cb_table = intern_streaming_tables(model, self.pool)
        return ModelEntry(
            model_id=model_id,
            version=version,
            path=path,
            model=model,
            format_version=sm.format_version,
            spec_name=model.spec.name if model.spec is not None else None,
            thr_codebook_bits=model.thr_codebook_bits,
            diagnostics=sm.diagnostics,
            thr_codebook_table=cb_table,
            interned=interned,
        )

    def register(self, model_id: str, path: str) -> ModelEntry:
        """Admit a new model (version 1).  Raises on duplicate id or any
        toadcheck error-severity finding."""
        entry = self._admit(model_id, path, version=1)
        with self._lock:
            if model_id in self._entries:
                entry.interned.release_all(self.pool)
                raise ValueError(
                    f"model_id {model_id!r} is already registered "
                    f"(version {self._entries[model_id].version}); "
                    f"use swap() to hot-swap it"
                )
            self._entries[model_id] = entry
        return entry

    def swap(self, model_id: str, path: str) -> ModelEntry:
        """Atomically hot-swap ``model_id`` to a new artifact.

        The new artifact is loaded + verified + interned *before* the map
        changes; a failure leaves the old version serving.  On success the
        serving version bumps by one and the old entry's tables are
        released from the pool.
        """
        with self._lock:
            old = self._entries.get(model_id)
        if old is None:
            raise UnknownModelError(model_id, self.ids())
        entry = self._admit(model_id, path, version=old.version + 1)
        with self._lock:
            current = self._entries.get(model_id)
            if current is not old and current is not None:
                # a concurrent swap won; ours still supersedes it
                entry.version = current.version + 1
                old = current
            self._entries[model_id] = entry
        old.interned.release_all(self.pool)
        return entry

    def remove(self, model_id: str) -> None:
        with self._lock:
            entry = self._entries.pop(model_id, None)
        if entry is None:
            raise UnknownModelError(model_id, self.ids())
        entry.interned.release_all(self.pool)

    @classmethod
    def from_dir(
        cls,
        directory: str,
        pool: TablePool | None = None,
        verify: bool = True,
        faults=None,
        streaming: bool = False,
        device="cuda",
    ) -> "ModelRegistry":
        """Build a registry from every ``*.toad`` / ``*.npz`` /
        ``*.toadpack`` artifact in a directory — model_id is the file stem.
        Any artifact that fails admission aborts the whole fleet build
        (:class:`ArtifactError`), naming *every* offending file — a rollout
        fixes all of them in one round trip, not one per launch attempt.

        Admission order is deterministic: sorted by file *name* (not the
        full path), so the same artifact set admits in the same order from
        any mount point and the admission log/serving versions are
        reproducible across hosts.  Each admission is logged with its
        elapsed milliseconds on the ``repro_torch.fleet.registry`` logger.
        """
        reg = cls(pool=pool, verify=verify, faults=faults,
                  streaming=streaming, device=device)
        paths = sorted(
            glob.glob(os.path.join(directory, "*.toad"))
            + glob.glob(os.path.join(directory, "*.npz"))
            + glob.glob(os.path.join(directory, "*.toadpack")),
            key=os.path.basename,
        )
        if not paths:
            raise ArtifactError(
                f"{directory}: no .toad/.npz/.toadpack artifacts found"
            )
        if verify:
            from repro_torch.analysis.diagnostics import errors, format_diagnostics
            from repro_torch.analysis.verify import verify_fleet

            bad = {
                p: errs
                for p, diags in verify_fleet(paths).items()
                if (errs := errors(diags))
            }
            if bad:
                detail = "\n".join(
                    f"{p}:\n{format_diagnostics(errs)}" for p, errs in bad.items()
                )
                raise ArtifactError(
                    f"{directory}: {len(bad)} of {len(paths)} artifact(s) "
                    f"failed structural verification:\n{detail}"
                )
        for p in paths:
            model_id = os.path.splitext(os.path.basename(p))[0]
            reg.register(model_id, p)
        return reg

    # --------------------------------------------------------------- lookup
    def get(self, model_id: str) -> ModelEntry:
        with self._lock:
            entry = self._entries.get(model_id)
        if entry is None:
            raise UnknownModelError(model_id, self.ids())
        return entry

    def ids(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def entries(self) -> list[ModelEntry]:
        with self._lock:
            return [self._entries[k] for k in sorted(self._entries)]

    def __contains__(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------------ reporting
    def manifest(self) -> dict:
        """The fleet manifest: every hosted (model_id, version) + dedup."""
        return {
            "n_models": len(self),
            "models": {e.model_id: e.describe() for e in self.entries()},
            "dedup": self.pool.stats(),
        }

    def memory_report(self) -> dict:
        """Per-model vs shared resident bytes (see ``repro_torch.fleet.dedup``)."""
        from repro_torch.fleet.dedup import fleet_memory_report

        return fleet_memory_report(self)
