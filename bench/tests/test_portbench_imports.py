"""Nothing the benchmark runs imports JAX or the JAX package: no module
under ``bench/`` names ``jax``, ``jaxlib``, ``flax`` or ``repro`` as the
top-level package of an import, compared whole (``repro_torch`` begins
with ``repro`` and is another package), and the plain reference under
``bench/ref/`` imports nothing of the program either."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(BENCH.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "ref").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "portbench" not in top_level_imports(path)


def test_whole_names_are_compared():
    sys.path.insert(0, str(BENCH))
    from portbench import harness

    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_probe"] = sys
        assert harness.jax_loaded() == sorted(
            {m.split(".")[0] for m in saved} & JAX)
        sys.modules["repro.core"] = sys
        assert "repro" in harness.jax_loaded()
    finally:
        sys.modules.pop("repro_torch_probe", None)
        sys.modules.pop("repro.core", None)
