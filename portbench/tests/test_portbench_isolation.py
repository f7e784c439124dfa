"""Nothing under ``portbench/`` imports JAX or the JAX package, compared by
each import's whole top-level name (``tpugan_torch`` begins with
``tpugan``), and the plain reference imports nothing of the program."""

from __future__ import annotations

import ast

import pytest

from portbench.tests.conftest import HERE

SOURCES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tpugan"}


def imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    bad = [m for m in imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert tops <= {"__future__", "contextlib", "importlib", "math", "numpy",
                    "torch", "portbench"}, tops
    assert not [m for m in imported(path) if m.startswith("portbench")
                and not m.startswith("portbench.reference")]
