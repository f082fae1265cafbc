"""Nothing under portbench imports JAX or the JAX package, compared on
the whole top-level name (``repro_torch`` is not ``repro``), and the
reference imports nothing of the program."""
from __future__ import annotations

import ast
import sys

import pytest
from conftest import ROOT

FILES = sorted(p for p in (ROOT / "portbench").rglob("*.py")
               if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
    assert "benchmarks" not in set(_imports(path))


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench" / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "contextlib", "typing",
                                   "torch", "numpy", "math"}


def test_run_holds_no_jax_module(checkout):
    from portbench import harness

    r = harness.run_cell(checkout, "tiny-bulk", 3, 1.0, False, "cpu", 0.0,
                         log=lambda s: None)
    assert r["correct"] is True
    assert harness.forbidden_modules() == []
    assert any(m.split(".")[0] == "repro_torch" for m in sys.modules)
