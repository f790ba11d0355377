"""The port's code lint (TOAD201-207, ``repro_torch.analysis.lint``): one
snippet a rule that fires and one that does not, the counterparts of
``tests/test_toadcheck.py``'s lint cases in torch and CUDA idiom; the
port's sources clean under ``tools/toadcheck_torch_baseline.json``; and the
CLI's exit codes."""

import json
from pathlib import Path

import pytest

from repro_torch.analysis import CATALOG, Baseline, format_diagnostics, lint_paths
from repro_torch.launch import toadcheck

REPO = Path(__file__).resolve().parents[1]
BASELINE = REPO / "tools" / "toadcheck_torch_baseline.json"


def _codes(diags):
    return sorted({d.code for d in diags})


def _lint(tmp_path, code, where="plain", name="mod.py", tests_dir=None):
    d = tmp_path / where
    d.mkdir(parents=True, exist_ok=True)
    f = d / name
    f.write_text(code)
    return lint_paths([str(f)], tests_dir=tests_dir)


# ---------------------------------------------------------------- TOAD201
def test_fp32_accumulation(tmp_path):
    diags = _lint(tmp_path, (
        "import torch\n"
        "def f(hist, counts, x):\n"
        "    a = hist.half()\n"
        "    b = counts.to(torch.bfloat16)\n"
        "    c = hist.float().to(dtype=torch.float16)\n"
        "    grad_sum = torch.zeros(4, dtype=torch.half)\n"
        "    return a, b, c, grad_sum\n"))
    assert _codes(diags) == ["TOAD201"] and {d.line for d in diags} == {3, 4, 5, 6}


def test_fp32_accumulation_clean(tmp_path):
    assert _lint(tmp_path, (
        "import torch\n"
        "def f(hist, x):\n"
        "    hist = hist.to(torch.float32)\n"
        "    counts = torch.zeros(4, dtype=torch.int64)\n"
        "    y = x.half()\n"                     # not an accumulator
        "    return hist.double(), counts, y\n")) == []


# ------------------------------------------------------------ TOAD202/203
def test_read_back_branch_in_a_hot_path(tmp_path):
    code = (
        "def f(x):\n"
        "    if (x > 0).any().item():\n"
        "        return 1\n"
        "    while x.sum().cpu() > 0:\n"
        "        x = x - 1\n"
        "    return 0\n")
    diags = _lint(tmp_path, code, where="kernels")
    assert _codes(diags) == ["TOAD202"] and {d.line for d in diags} == {2, 4}


def test_read_back_branch_cold_or_on_the_device_is_clean(tmp_path):
    code = "def f(x):\n    if (x > 0).any().item():\n        return 1\n    return 0\n"
    assert _lint(tmp_path, code, where="plain") == []      # cold path exempt
    on_device = ("import torch\n"
                 "def f(x, n: int):\n"
                 "    if n > 0:\n"                        # a host value
                 "        x = torch.where(x > 0, x, 0.0)\n"
                 "    return x\n")
    assert _lint(tmp_path, on_device, where="kernels") == []


def test_read_back_in_a_hot_loop(tmp_path):
    code = (
        "import torch\n"
        "def f(xs):\n"
        "    out = []\n"
        "    for x in xs:\n"
        "        out.append(x.tolist())\n"
        "        torch.cuda.synchronize()\n"
        "    return out\n")
    diags = _lint(tmp_path, code, where="gbdt", name="trainer.py")
    assert _codes(diags) == ["TOAD203"] and diags[0].line == 4
    assert "2 host read-back(s)" in diags[0].message


def test_read_back_once_after_the_loop_is_clean(tmp_path):
    code = (
        "import torch\n"
        "def f(xs):\n"
        "    acc = []\n"
        "    for x in xs:\n"
        "        acc.append(x * 2)\n"
        "    return torch.stack(acc).cpu()\n")
    assert _lint(tmp_path, code, where="gbdt", name="trainer.py") == []
    assert _lint(tmp_path, code.replace("x * 2", "x.item()"), where="plain") == []


# ---------------------------------------------------------------- TOAD204
def test_gpu_tests_must_gate_on_the_capability(tmp_path):
    code = (
        "import pytest, torch\n"
        "@pytest.mark.gpu\n"
        "def test_ungated():\n"
        "    if not torch.cuda.is_available():\n"
        "        pytest.skip('no card')\n"
        "@pytest.mark.gpu\n"
        "def test_gated_in_body():\n"
        "    if torch.cuda.get_device_capability(0) != (9, 0):\n"
        "        pytest.skip('not sm_90a')\n"
        "@pytest.fixture()\n"
        "def card():\n"
        "    if torch.cuda.get_device_capability() == (9, 0):\n"
        "        return 'cuda'\n"
        "    pytest.skip('not sm_90a')\n"
        "@pytest.mark.gpu\n"
        "def test_gated_by_fixture(card):\n"
        "    pass\n")
    diags = _lint(tmp_path, code, where="tests", name="test_x.py")
    assert _codes(diags) == ["TOAD204"] and [d.line for d in diags] == [3]
    module = "import pytest\npytestmark = pytest.mark.gpu\ndef test_a():\n    pass\n"
    diags = _lint(tmp_path, module, where="tests", name="test_y.py")
    assert _codes(diags) == ["TOAD204"] and diags[0].line == 2
    gated = module + ("def test_b():\n    import torch\n"
                      "    assert torch.cuda.get_device_capability(0) == (9, 0)\n")
    assert _lint(tmp_path, gated, where="tests", name="test_z.py") == []


def test_kernel_wrapper_must_not_fall_back_to_its_plain_version(tmp_path):
    code = (
        "from .ref import histogram_ref\n"
        "def histogram(x):\n"
        "    try:\n"
        "        return _launch(x)\n"
        "    except RuntimeError:\n"
        "        return histogram_ref(x)\n"
        "def build():\n"
        "    try:\n"
        "        return _compile()\n"
        "    except RuntimeError as exc:\n"
        "        raise RuntimeError('nvcc failed') from exc\n")
    diags = _lint(tmp_path, code, where="kernels")
    assert _codes(diags) == ["TOAD204"] and [d.line for d in diags] == [5]
    assert _lint(tmp_path, code, where="plain") == []   # only kernels/


def test_port_gpu_tests_are_held_through_tests_dir(tmp_path):
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_ungated.py").write_text(
        "import pytest\n@pytest.mark.gpu\ndef test_a():\n    pass\n")
    (tests / "test_jax_side.py").write_text(   # not a port test: not held
        "import pytest\n@pytest.mark.gpu\ndef test_a():\n    pass\n")
    diags = _lint(tmp_path, "x = 1\n", tests_dir=str(tests))
    assert _codes(diags) == ["TOAD204"]
    assert [Path(d.file).name for d in diags] == ["test_torch_ungated.py"]


# ---------------------------------------------------------------- TOAD205
def test_registry_contract(tmp_path):
    diags = _lint(tmp_path, (
        "from repro_torch.core.pipeline import register_stage, CompressionStage\n"
        "@register_stage\n"
        "class Broken(CompressionStage):\n"
        "    pass\n"
        "@register_stage\n"
        "class A(CompressionStage):\n"
        "    name = 'dup'\n"
        "    def apply(self, ctx): ...\n"
        "@register_stage\n"
        "class B(CompressionStage):\n"
        "    name = 'dup'\n"
        "    def apply(self, ctx): ...\n"))
    assert _codes(diags) == ["TOAD205"]
    msgs = " ".join(d.message for d in diags)
    assert "name" in msgs and "apply" in msgs and "already registered" in msgs


def test_registry_contract_clean(tmp_path):
    assert _lint(tmp_path, (
        "from repro_torch.api.backends import register_backend, PredictorBackend\n"
        "@register_backend\n"
        "class Good(PredictorBackend):\n"
        "    name = 'good'\n"
        "    def build(self, model): ...\n")) == []


# ---------------------------------------------------------------- TOAD206
def test_backend_parity_test_required_in_port_tests(tmp_path):
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_something.py").write_text("BACKENDS = ['covered']\n")
    (tests / "test_jax_only.py").write_text("BACKENDS = ['orphan']\n")
    code = (
        "from repro_torch.api.backends import register_backend, PredictorBackend\n"
        "@register_backend\n"
        "class Covered(PredictorBackend):\n"
        "    name = 'covered'\n"
        "    def build(self, model): ...\n"
        "@register_backend\n"
        "class Orphan(PredictorBackend):\n"
        "    name = 'orphan'\n"
        "    def build(self, model): ...\n")
    diags = _lint(tmp_path, code, tests_dir=str(tests))
    assert _codes(diags) == ["TOAD206"] and len(diags) == 1
    assert "orphan" in diags[0].message
    (tests / "test_torch_orphan.py").write_text("NAME = \"orphan\"\n")
    assert _lint(tmp_path, code, tests_dir=str(tests)) == []


# ---------------------------------------------------------------- TOAD207
def test_serving_queue_and_bare_except(tmp_path):
    code = (
        "import queue\n"
        "q1 = queue.Queue()\n"                 # unbounded: flagged
        "q2 = queue.Queue(maxsize=8)\n"        # bounded: fine
        "q3 = queue.Queue(0)\n"                # explicit positional: fine
        "def f():\n"
        "    try:\n"
        "        pass\n"
        "    except:\n"                        # bare: flagged
        "        pass\n"
        "    try:\n"
        "        pass\n"
        "    except Exception:\n"              # typed: fine
        "        pass\n")
    diags = _lint(tmp_path, code, where="fleet")
    assert _codes(diags) == ["TOAD207"] and {d.line for d in diags} == {2, 8}
    assert _lint(tmp_path, code, where="plain") == []  # outside the serving layer
    engine = _lint(tmp_path, code, where="api", name="engine.py")
    assert _codes(engine) == ["TOAD207"] and len(engine) == 2


# ------------------------------------------------------------ the port's tree
def test_port_is_clean_under_its_baseline():
    diags = lint_paths([str(REPO / "src" / "repro_torch")], tests_dir=str(REPO / "tests"))
    baseline = Baseline.load(str(BASELINE))
    fresh = baseline.apply(diags)
    assert fresh == [], format_diagnostics(fresh)
    assert all(baseline.entries[d.fingerprint()].strip() for d in diags), \
        "every baselined finding needs a non-empty justification"
    assert all(j.strip() for j in baseline.entries.values())
    assert {d.code for d in diags} <= {c for c in CATALOG if c.startswith("TOAD2")}


def test_every_lint_code_is_catalogued_as_an_error():
    for code in ("TOAD201", "TOAD202", "TOAD203", "TOAD204", "TOAD205", "TOAD206",
                 "TOAD207"):
        assert CATALOG[code][0] == "error" and CATALOG[code][1]


# ------------------------------------------------------------------- the CLI
def test_cli_on_a_directory_and_on_a_seeded_violation(tmp_path, capsys):
    assert toadcheck.main([str(REPO / "src" / "repro_torch")]) == 0
    assert "0 error(s)" in capsys.readouterr().out
    bad = tmp_path / "kernels"
    bad.mkdir()
    (bad / "k.py").write_text("def f(hist):\n    return hist.half()\n")
    assert toadcheck.main([str(bad), "--no-baseline", "--format", "json",
                           "--tests-dir", str(tmp_path)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [d["code"] for d in doc] == ["TOAD201"] and doc[0]["line"] == 2


def test_cli_baseline_round_trip(tmp_path, capsys):
    src = tmp_path / "kernels"
    src.mkdir()
    (src / "k.py").write_text("def f(hist):\n    return hist.half()\n")
    base = tmp_path / "base.json"
    args = [str(src), "--baseline", str(base), "--tests-dir", str(tmp_path)]
    assert toadcheck.main([*args, "--write-baseline"]) == 2    # no justification
    assert "--justification" in capsys.readouterr().err
    assert toadcheck.main([*args, "--write-baseline", "--justification",
                           "a seeded finding"]) == 0
    assert toadcheck.main(args) == 0
    assert "(1 baselined)" in capsys.readouterr().out
    assert toadcheck.main([*args, "--no-baseline"]) == 1
    assert toadcheck.main([str(tmp_path / "missing.py")]) == 2


@pytest.mark.parametrize("path", ["src/repro_torch/kernels", "src/repro_torch/gbdt/trainer.py",
                                  "src/repro_torch/tracing.py",
                                  "src/repro_torch/kernels/commit.py"])
def test_hot_paths_have_no_read_backs(path):
    """The hot paths read nothing back, not even grandfathered."""
    diags = lint_paths([str(REPO / path)])
    assert [d for d in diags if d.code in ("TOAD202", "TOAD203")] == []
