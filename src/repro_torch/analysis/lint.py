"""Layer 2 of the port's toadcheck: an AST lint of the port's own sources
(``repro.analysis.lint``'s rules, translated to PyTorch and CUDA idiom).

The codes, severities and meaning of the JAX package's ``TOAD2xx`` rules
are kept; what each rule looks for is the port's counterpart:

* **TOAD201** — fp32 accumulation: a count/histogram/accumulator tensor
  (a name holding one of ``_ACC_NAMES``) cast with ``.half()``,
  ``.bfloat16()``, ``.to(torch.float16 / torch.bfloat16 / torch.half)``
  (or ``.astype`` of a half dtype), or allocated with such a ``dtype=``.
* **TOAD202** — in a hot path, a Python ``if``/``while`` whose test reads
  a tensor back to the host (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``): a hidden synchronisation, where JAX's rule catches a
  branch on a traced value.  The trainer's round loop never reads back.
* **TOAD203** — in a hot path, a host read-back or
  ``torch.cuda.synchronize()`` inside a Python loop: a sync on every trip
  (JAX's rule: ``jnp`` calls that unroll into the trace).
* **TOAD204** — gating of the card's code, two halves: (a) a test module
  or test marked ``gpu`` must decide whether it may run by comparing
  ``get_device_capability(...)`` with ``(9, 0)`` (in its body, a fixture
  of its module it requests, or, for a module-wide mark, anywhere in the
  module): the kernels are built for ``sm_90a`` only; (b) in ``kernels/``
  a ``try`` whose handler calls a ``*_ref`` function is a silent fallback
  that hides a kernel which did not build or launch.  JAX's
  ``interpret=``/``static_argnames`` half has no torch counterpart:
  eager PyTorch traces nothing, and a wrapper picks its plain version from
  the tensor's device.
* **TOAD205** — ``@register_stage`` classes define ``name`` and ``apply``
  in their body, ``@register_backend`` classes ``name`` and ``build``
  (``core/pipeline.py``, ``api/backends.py``); names are unique.
* **TOAD206** — every registered backend name appears quoted in a port
  test, ``tests/test_torch_*.py`` (the JAX package's tests name
  ``packed`` and ``reference`` too, so they do not count).
* **TOAD207** — in the serving layer (``api/engine.py`` and ``fleet/``):
  ``queue.Queue()`` without ``maxsize`` and a bare ``except:``.

Hot paths are the JAX set, ``kernels/`` and ``gbdt/trainer.py``, and
``tracing.py``, whose spans run inside them.  The lint is syntactic (no
type inference) and errs toward reporting; deliberate exceptions are
grandfathered in ``tools/toadcheck_torch_baseline.json``, each with a
justification.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path

from repro_torch.analysis.diagnostics import Diagnostic

#: substrings that mark a tensor as a count/accumulator (TOAD201)
_ACC_NAMES = ("hist", "count", "cnt", "accum", "grad_sum", "hess_sum")
#: dtype attribute/string names that violate fp32 accumulation
_HALF_DTYPES = {"bfloat16", "float16", "half", "bf16", "f16"}
#: tensor methods that cast to a half dtype with no argument
_HALF_METHODS = {"half", "bfloat16"}
#: tensor methods that read a tensor back to the host (TOAD202/203)
_READ_BACKS = {"item", "tolist", "cpu", "numpy"}
#: path fragments that mark a file as a hot path (TOAD202/203)
_HOT_PARTS = (os.sep + "kernels" + os.sep,
              os.sep + "gbdt" + os.sep + "trainer.py",
              os.sep + "repro_torch" + os.sep + "tracing.py")
#: path fragments of the kernels' package (TOAD204 b)
_KERNEL_PARTS = (os.sep + "kernels" + os.sep,)
#: path fragments that mark a file as serving-layer code (TOAD207)
_SERVING_PARTS = (os.sep + "api" + os.sep + "engine.py",
                  os.sep + "fleet" + os.sep)
#: the port's own tests, the corpus of TOAD206 and the gpu tests of TOAD204
PORT_TESTS = "test_torch_*.py"
_CAPABILITY = (9, 0)


def _root_name(node: ast.AST) -> str:
    """Leftmost name of an attribute chain: torch.cuda.foo -> 'torch'."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else ""


def _call_name(call: ast.Call) -> str:
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")


def _value_name(node: ast.AST) -> str:
    """Best-effort identifier text for 'is this a count tensor' checks."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        return _value_name(node.value)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return _value_name(node.func.value)  # hist.float().half(): 'hist'
    return ""


def _is_half_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in _HALF_DTYPES
    if isinstance(node, ast.Attribute):
        return node.attr in _HALF_DTYPES
    return False


def _is_read_back(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _call_name(node)
    if name in _READ_BACKS and isinstance(node.func, ast.Attribute):
        return True
    return name == "synchronize" and _root_name(node.func) == "torch"


def _read_backs(node: ast.AST):
    for sub in ast.walk(node):
        if _is_read_back(sub):
            yield sub


def _is_gpu_mark(node: ast.AST) -> bool:
    """``pytest.mark.gpu`` (or a call of it)."""
    if isinstance(node, ast.Call):
        node = node.func
    return (isinstance(node, ast.Attribute) and node.attr == "gpu"
            and isinstance(node.value, ast.Attribute) and node.value.attr == "mark")


def _gates_capability(node: ast.AST) -> bool:
    """A comparison of ``get_device_capability(...)`` with ``(9, 0)``."""
    for sub in ast.walk(node):
        if not (isinstance(sub, ast.Compare) and len(sub.ops) == 1
                and isinstance(sub.ops[0], (ast.Eq, ast.NotEq))):
            continue
        sides = (sub.left, sub.comparators[0])
        call = any(isinstance(s, ast.Call) and _call_name(s) == "get_device_capability"
                   for s in sides)
        pair = any(isinstance(s, ast.Tuple) and all(isinstance(e, ast.Constant)
                                                    for e in s.elts)
                   and tuple(e.value for e in s.elts) == _CAPABILITY for s in sides)
        if call and pair:
            return True
    return False


class _FileLint(ast.NodeVisitor):
    def __init__(self, path: str, source: str, hot: bool, serving: bool = False,
                 kernels: bool = False, gpu_tests_only: bool = False):
        self.path = path
        self.lines = source.splitlines()
        self.hot = hot
        self.serving = serving
        self.kernels = kernels
        self.gpu_tests_only = gpu_tests_only
        self.diags: list[Diagnostic] = []
        # (registry, name) -> (path, line); shared across files by lint_paths
        self.registered: dict[tuple[str, str], tuple[str, int]] = {}

    def diag(self, code: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        src = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        self.diags.append(Diagnostic(code=code, message=message, file=self.path,
                                     line=line, source=src))

    # ---- TOAD201: fp32 accumulation --------------------------------------
    def _check_half_cast(self, node: ast.Call) -> None:
        if not isinstance(node.func, ast.Attribute):
            return
        method = node.func.attr
        by_method = method in _HALF_METHODS and not node.args and not node.keywords
        by_dtype = method in ("to", "type", "astype") and (
            any(_is_half_dtype(a) for a in node.args)
            or any(kw.arg == "dtype" and _is_half_dtype(kw.value) for kw in node.keywords))
        name = _value_name(node.func.value).lower()
        if (by_method or by_dtype) and any(a in name for a in _ACC_NAMES):
            self.diag("TOAD201", node,
                      f"count/histogram tensor {name!r} cast to a half-precision "
                      f"dtype (.{method}); accumulators must stay float32")

    def _check_half_alloc(self, node: ast.Assign) -> None:
        targets = [_value_name(t).lower() for t in node.targets]
        if not any(a in t for t in targets for a in _ACC_NAMES):
            return
        for call in ast.walk(node.value):
            if isinstance(call, ast.Call):
                for kw in call.keywords:
                    if kw.arg == "dtype" and _is_half_dtype(kw.value):
                        self.diag("TOAD201", node,
                                  f"count/histogram tensor "
                                  f"{' / '.join(filter(None, targets))!r} "
                                  f"allocated with a half-precision dtype")
                        return

    # ---- TOAD202 / TOAD203: host read-backs in a hot path ----------------
    def _check_branch_read_back(self, node: ast.If | ast.While) -> None:
        if self.hot and any(True for _ in _read_backs(node.test)):
            kind = "if" if isinstance(node, ast.If) else "while"
            self.diag("TOAD202", node,
                      f"Python `{kind}` in a hot path tests a value read back "
                      f"from the device: a hidden synchronisation")

    def _check_loop(self, node: ast.For | ast.While) -> None:
        if not self.hot:
            return
        n = sum(1 for body in node.body for _ in _read_backs(body))
        if n:
            self.diag("TOAD203", node,
                      f"Python loop in a hot path holds {n} host read-back(s) "
                      f"or synchronize() call(s): a sync on every trip")

    # ---- TOAD204: gating of the card's code --------------------------------
    def _check_gpu_tests(self, tree: ast.Module) -> None:
        if not Path(self.path).name.startswith("test_"):
            return
        defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "pytestmark" for t in stmt.targets):
                marks = stmt.value.elts if isinstance(stmt.value, (ast.List, ast.Tuple)) \
                    else [stmt.value]
                if any(_is_gpu_mark(m) for m in marks) and not _gates_capability(tree):
                    self.diag("TOAD204", stmt,
                              "gpu-marked test module never compares "
                              "get_device_capability() with (9, 0): the kernels "
                              "are built for sm_90a only")
        for fn in defs.values():
            if not fn.name.startswith("test") or not any(
                    _is_gpu_mark(d) for d in fn.decorator_list):
                continue
            fixtures = [defs[a.arg] for a in fn.args.args if a.arg in defs]
            if not any(_gates_capability(n) for n in [fn, *fixtures]):
                self.diag("TOAD204", fn,
                          f"gpu-marked {fn.name}() does not compare "
                          f"get_device_capability() with (9, 0) (in its body or "
                          f"a fixture it requests)")

    def visit_Try(self, node: ast.Try) -> None:
        if self.kernels:
            for handler in node.handlers:
                refs = [c for c in ast.walk(handler) if isinstance(c, ast.Call)
                        and _call_name(c).endswith("_ref")]
                if refs:
                    self.diag("TOAD204", handler,
                              f"`except` in kernels/ falls back to "
                              f"{_call_name(refs[0])}(): a kernel that fails to "
                              f"build or launch is hidden; raise instead")
        self.generic_visit(node)

    # ---- TOAD205: registry contracts --------------------------------------
    def _check_registration(self, node: ast.ClassDef) -> None:
        decs = {d.id for d in node.decorator_list if isinstance(d, ast.Name)}
        registry = ("stage" if "register_stage" in decs else
                    "backend" if "register_backend" in decs else None)
        if registry is None:
            return
        required = "apply" if registry == "stage" else "build"
        methods = {n.name for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        name_val = None
        for stmt in node.body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and t.id == "name" and \
                            isinstance(stmt.value, ast.Constant) and \
                            isinstance(stmt.value.value, str):
                        name_val = stmt.value.value
        if name_val is None:
            self.diag("TOAD205", node,
                      f"@register_{registry} class {node.name} defines no "
                      f"literal `name = \"...\"`; the registry would key it "
                      f"under the inherited placeholder")
        if required not in methods:
            self.diag("TOAD205", node,
                      f"@register_{registry} class {node.name} does not "
                      f"define {required}() in its body")
        if name_val is not None:
            key = (registry, name_val)
            if key in self.registered:
                where = self.registered[key]
                self.diag("TOAD205", node,
                          f"{registry} name {name_val!r} already registered "
                          f"at {where[0]}:{where[1]}; the second "
                          f"registration silently wins")
            else:
                self.registered[key] = (self.path, node.lineno)

    # ---- TOAD207: serving-layer robustness --------------------------------
    def _check_unbounded_queue(self, node: ast.Call) -> None:
        if not (self.serving and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("Queue", "LifoQueue", "PriorityQueue")
                and _root_name(node.func) == "queue"):
            return
        has_maxsize = bool(node.args) or any(
            kw.arg in ("maxsize", None) for kw in node.keywords)  # None = **kw
        if not has_maxsize:
            self.diag("TOAD207", node,
                      "queue.Queue() without maxsize in the serving layer: "
                      "an unbounded queue turns overload into latency "
                      "collapse; pass maxsize= (0 = deliberate unbounded)")

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if self.serving and node.type is None:
            self.diag("TOAD207", node,
                      "bare `except:` in the serving layer catches "
                      "SystemExit/KeyboardInterrupt inside worker threads; "
                      "catch Exception (or narrower)")
        self.generic_visit(node)

    # ---- dispatch ----------------------------------------------------------
    def visit_Module(self, node: ast.Module) -> None:
        self._check_gpu_tests(node)
        if not self.gpu_tests_only:
            self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        self._check_half_cast(node)
        self._check_unbounded_queue(node)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_half_alloc(node)
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        self._check_branch_read_back(node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch_read_back(node)
        self._check_loop(node)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        self._check_loop(node)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._check_registration(node)
        self.generic_visit(node)


def _iter_py_files(paths: list[str]):
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        else:
            yield path


def _parse(f: Path, diags: list[Diagnostic]):
    try:
        source = f.read_text(encoding="utf-8")
        return source, ast.parse(source, filename=str(f))
    except (OSError, SyntaxError) as e:
        diags.append(Diagnostic(code="TOAD205", file=str(f),
                                message=f"file does not parse: {e}"))
        return None, None


def lint_paths(paths: list[str], tests_dir: str | None = None) -> list[Diagnostic]:
    """Run every TOAD2xx rule over ``paths`` (files or directories).

    ``tests_dir`` adds the port's tests (``test_torch_*.py`` there): each
    ``@register_backend`` name found in the linted sources must appear
    quoted in one of them (TOAD206), and their ``gpu``-marked tests are
    held to TOAD204's capability gate.
    """
    diags: list[Diagnostic] = []
    registered: dict[tuple[str, str], tuple[str, int]] = {}
    seen: set[Path] = set()
    for f in _iter_py_files(paths):
        seen.add(f.resolve())
        source, tree = _parse(f, diags)
        if tree is None:
            continue
        s = str(f)
        lint = _FileLint(s, source, hot=any(p in s for p in _HOT_PARTS),
                         serving=any(p in s for p in _SERVING_PARTS),
                         kernels=any(p in s for p in _KERNEL_PARTS))
        lint.registered = registered  # shared: dup names across files
        lint.visit(tree)
        diags.extend(lint.diags)

    if tests_dir is not None and Path(tests_dir).is_dir():
        tests = sorted(Path(tests_dir).glob(PORT_TESTS))
        corpus = "\n".join(t.read_text(encoding="utf-8") for t in tests)
        for t in tests:
            if t.resolve() in seen:
                continue
            source, tree = _parse(t, diags)
            if tree is not None:
                lint = _FileLint(str(t), source, hot=False, gpu_tests_only=True)
                lint.visit(tree)
                diags.extend(lint.diags)
        for (registry, name), (path, line) in sorted(registered.items()):
            if registry != "backend":
                continue
            if f'"{name}"' not in corpus and f"'{name}'" not in corpus:
                diags.append(Diagnostic(
                    code="TOAD206", file=path, line=line,
                    message=f"backend {name!r} has no parity test: the name "
                            f"never appears quoted in {tests_dir}/{PORT_TESTS}",
                    source=f'name = "{name}"',
                ))
    return diags
