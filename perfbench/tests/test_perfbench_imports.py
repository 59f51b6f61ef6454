"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``diff_sampler_tpu_torch`` passes), and the plain
reference imports nothing of the system under test."""

import ast
import subprocess
import sys
import textwrap

import pytest

from perfbench import core

SOURCES = sorted(p for p in core.HERE.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((core.HERE / "reference").glob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(core.ROOT)))
def test_no_jax_in_the_benchmark(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in core.FORBIDDEN]
    assert not bad


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_system(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "math", "contextlib", "contextvars", "typing", "numpy",
                    "torch"}, tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "diff_sampler_tpu_torch_probe", sys)
    assert "diff_sampler_tpu" not in core.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", sys)
    assert core.loaded_forbidden() == ["jaxlib"]


def test_a_run_loads_no_jax():
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(core.ROOT)!r})
        from _pytest.monkeypatch import MonkeyPatch
        from perfbench import core
        from perfbench.harness import run_cell
        from perfbench.tests.tiny import tiny_cells
        for cell in tiny_cells(MonkeyPatch()):
            run_cell(cell["name"], 5, 0.2, False, device="cpu", cell=cell)
        print("LOADED", core.loaded_forbidden())
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_run_refuses_without_a_card_and_prints_nothing():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(core.HERE / "run.py"), "--workload",
                          "cifar10-ipndm10-b256", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
