"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Top-level module names are
compared whole: the program's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmarks"
FORBIDDEN = {"jax", "jaxlib", "flax", "deeplearning4j_tpu"}
PROGRAM = "deeplearning4j_tpu_torch"
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "tests" not in p.relative_to(BENCH).parts
                 and ".cache" not in p.parts)


def _tops(path: Path) -> set[str]:
    """Top-level names of every module a file imports, anywhere in it."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    assert not (_tops(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not (_tops(path) & (FORBIDDEN | {PROGRAM, "benchmarks"}))


def _loaded(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_harness_and_program_load_no_jax():
    # every module of the harness (its modes too), the traffic's pieces,
    # the readers, and the program's modules that the cells drive
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for d in ("harness", "traffic")
                  for p in (BENCH / d).rglob("*.py"))
    code = "\n".join(
        ["import sys, importlib.util", f"sys.path.insert(0, {str(ROOT)!r})",
         "import benchmarks.run"]
        + [f"import {m}" for m in mods]
        + ["import deeplearning4j_tpu_torch.models.transformer",
         "import deeplearning4j_tpu_torch.serving.engine",
         "import deeplearning4j_tpu_torch.serving.scheduler",
         "import deeplearning4j_tpu_torch.obs.trace"]
        + [f"s = importlib.util.spec_from_file_location('m{i}', {str(p)!r})\n"
           f"importlib.util.module_from_spec(s); s.loader.exec_module("
           f"importlib.util.module_from_spec(s))"
           for i, p in enumerate(sorted((BENCH / "metrics").glob("*.py")))])
    loaded = _loaded(code)
    assert PROGRAM in loaded
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(f"import sys\nsys.path.insert(0, {str(BENCH)!r})\n"
                     "import reference.gpt2_plain")
    assert not (loaded & (FORBIDDEN | {PROGRAM})), loaded


def test_the_runs_check_names_whole_top_level_names(monkeypatch):
    from benchmarks.harness import core

    monkeypatch.setitem(sys.modules, "deeplearning4j_tpu_torch_x", sys)
    assert "deeplearning4j_tpu" not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert core.forbidden_loaded() == ["jaxlib"]
