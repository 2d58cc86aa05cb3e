"""No module of the benchmark imports JAX or the JAX package; the reference nothing of the program."""

import ast
from pathlib import Path

import pytest

from flagbench import harness

MODULES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(harness.HERE).as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


def test_names_are_compared_whole():
    assert "katsdpsigproc_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert top_level_imports(harness.HERE / "loops.py") >= {"torch"}


@pytest.mark.parametrize("name", ["reference.py", "counts.py", "data.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert top_level_imports(harness.HERE / name) <= {"numpy", "torch"}


def test_forbidden_modules_check(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]
