"""Nothing of the benchmark imports JAX or the JAX package (compared by
whole top-level module names: the port's name begins with the JAX
package's), and the yardstick imports nothing of the program."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").glob("*.py"))
    + sorted((HERE / "frozen").glob("*.py")),
    ids=lambda p: str(p.relative_to(HERE)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import repro_torch  # noqa: F401  (the port: its name begins "repro")

    monkeypatch.setitem(sys.modules, "reprox", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.engine", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "repro"]
