"""Typed diagnostics of the port's toadcheck (``repro.analysis.diagnostics``).

One :class:`Diagnostic` shape for every finding of the artifact/stream
verifier (``repro_torch.analysis.verify``: codes ``TOAD0xx`` for the
stream, ``TOAD1xx`` for the bundle).  Every code is registered in
:data:`CATALOG` with a default severity and a one-line fix hint, so a
finding is self-explanatory without opening the docs.  The codes and
their meaning are the JAX package's, so both packages report a defect
alike.  The port carries the codes it emits: the ``.toadpack`` container
codes (TOAD110-TOAD114) come with the streaming slice, and the code-lint
codes (TOAD2xx) with the lint.

Severity policy:

* ``error``   — the artifact is unsafe to dereference.  Load paths refuse.
* ``warning`` — well-formed but suspicious (e.g. a version overclaim that
  needlessly locks out old runtimes).  Reported, never fatal.
* ``info``    — observations for ``--format json`` consumers.

Baselines: grandfathered findings live in a JSON file keyed by
``(code, file, content hash)`` — content hashes, not line numbers, so
unrelated edits don't invalidate entries.  Every entry carries a
``justification`` string.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

ERROR = "error"
WARNING = "warning"
INFO = "info"


def _norm_path(path: str) -> str:
    """Anchor a file path at src/ | tests/ | tools/ for stable fingerprints."""
    p = path.replace("\\", "/")
    for anchor in ("src/", "tests/", "tools/"):
        i = p.find(anchor)
        if i != -1:
            return p[i:]
    return p

#: code -> (default severity, one-line fix hint)
CATALOG: dict[str, tuple[str, str]] = {
    # ---- stream-level (verify_stream) -----------------------------------
    "TOAD001": (ERROR, "stream truncated: re-export the artifact; a field "
                       "reads past the declared bit length"),
    "TOAD002": (ERROR, "trailing bits after the trees section: the encoder "
                       "and the header disagree about the model shape"),
    "TOAD003": (ERROR, "metadata field out of domain: the header does not "
                       "describe a well-formed ensemble"),
    "TOAD004": (ERROR, "non-finite value in a shared table: re-run the "
                       "compression pipeline; NaN/inf never round-trips"),
    "TOAD005": (ERROR, "feature map invalid: indices must be strictly "
                       "increasing and < d"),
    "TOAD006": (ERROR, "threshold list not sorted: breaks the binning "
                       "equivalence bin<=e <=> x<=edges[e]"),
    "TOAD007": (ERROR, "codebook reference out of range: ref must be < the "
                       "shared-table entry count"),
    "TOAD008": (ERROR, "threshold codebook invalid: table must be strictly "
                       "increasing (every distinct value exactly once)"),
    "TOAD009": (ERROR, "tree node reference out of range: feature ref, "
                       "threshold index or leaf ref points outside its table"),
    "TOAD010": (WARNING, "split in an unreachable subtree: harmless to "
                         "traverse but wastes stream bytes; retrain/re-encode"),
    # ---- bundle-level (verify_bundle) -----------------------------------
    "TOAD101": (ERROR, "not a .toad artifact: required key missing or "
                       "meta_json unparseable"),
    "TOAD102": (ERROR, "format version unsupported by this runtime: upgrade "
                       "the runtime or re-export the artifact"),
    "TOAD103": (ERROR, "version stamp does not match the stream layout: "
                       "stamp the lowest sufficient version at save"),
    "TOAD104": (ERROR, "manifest byte accounting disagrees with the stream: "
                       "regenerate the manifest from the shipped forest"),
    "TOAD105": (ERROR, "spec and stream disagree about the threshold-"
                       "codebook layout: re-save with the producing spec"),
    "TOAD106": (ERROR, "encoded-stream digest mismatch: the ToaD bit stream "
                       "is corrupted; restore from the producer"),
    "TOAD107": (ERROR, "forest arrays invalid: edge rows must stay sorted "
                       "and references inside their tables"),
    "TOAD108": (WARNING, "eval fingerprint missing from a v2+ bundle: "
                         "value-level drift cannot be detected at load"),
    # ---- early-exit bound table (verify_bundle) ------------------------
    "TOAD120": (ERROR, "early_exit bound table does not match the shipped "
                       "trees: regenerate the artifact so margin exits stay "
                       "label-exact"),
    "TOAD121": (ERROR, "early_exit section malformed: remaining_mass must "
                       "be a finite (n_trees+1, n_classes) non-increasing "
                       "suffix table ending at zero, with a parseable "
                       "policy"),
}


@dataclasses.dataclass
class Diagnostic:
    """One typed toadcheck finding."""

    code: str               # "TOAD007"
    message: str            # what is wrong, with the offending values
    severity: str = ""      # error | warning | info; default from CATALOG
    hint: str = ""          # one-line fix hint; default from CATALOG
    file: str = ""          # artifact path or source file
    line: int = 0           # 1-based source line (lint findings)
    section: str = ""       # stream section name (verifier findings)
    bit_offset: int = -1    # bit position inside the stream (-1 = n/a)
    source: str = ""        # offending source line text (lint findings)

    def __post_init__(self):
        sev, hint = CATALOG.get(self.code, (ERROR, ""))
        if not self.severity:
            self.severity = sev
        if not self.hint:
            self.hint = hint

    @property
    def location(self) -> str:
        if self.line:
            return f"{self.file}:{self.line}"
        if self.section:
            at = f"@bit {self.bit_offset}" if self.bit_offset >= 0 else ""
            base = f"stream:{self.section}{at}"
            return f"{self.file}:{base}" if self.file else base
        return self.file or "-"

    def fingerprint(self) -> str:
        """Stable baseline key: code + file + content hash (not line number).

        Lint findings hash the offending source line, so entries survive
        unrelated edits above them; verifier findings hash the section name
        (artifact findings are not meant to be baselined, but the key stays
        well-defined).  The file component is normalized to start at the
        repo's top-level package dirs, so absolute and relative invocation
        paths produce the same key.
        """
        basis = self.source.strip() if self.source else self.section
        h = hashlib.sha1(basis.encode("utf-8")).hexdigest()[:8]
        return f"{self.code}:{_norm_path(self.file)}:{h}"

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["location"] = self.location
        d["fingerprint"] = self.fingerprint()
        return d

    def format_text(self) -> str:
        return (f"{self.severity:7s} {self.code} {self.location}: "
                f"{self.message}\n        hint: {self.hint}")


def format_diagnostics(diags: list[Diagnostic], fmt: str = "text") -> str:
    """Render a finding list as text or a JSON document."""
    if fmt == "json":
        return json.dumps([d.as_dict() for d in diags], indent=2)
    if fmt != "text":
        raise ValueError(f"format must be text|json, got {fmt!r}")
    if not diags:
        return "no findings"
    return "\n".join(d.format_text() for d in diags)


def errors(diags: list[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


# --------------------------------------------------------------------------
# Baseline (grandfathered findings)
# --------------------------------------------------------------------------


class Baseline:
    """Fingerprint-keyed suppression list with per-entry justifications."""

    def __init__(self, entries: dict[str, str] | None = None):
        self.entries = dict(entries or {})  # fingerprint -> justification

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        return cls({e["fingerprint"]: e.get("justification", "")
                    for e in raw.get("entries", [])})

    def save(self, path: str) -> None:
        doc = {
            "comment": "toadcheck grandfathered findings; every entry needs "
                       "a justification (see docs/analysis.md)",
            "entries": [
                {"fingerprint": fp, "justification": j}
                for fp, j in sorted(self.entries.items())
            ],
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")

    def suppresses(self, diag: Diagnostic) -> bool:
        return diag.fingerprint() in self.entries

    def apply(self, diags: list[Diagnostic]) -> list[Diagnostic]:
        """The findings that are *not* grandfathered."""
        return [d for d in diags if not self.suppresses(d)]
