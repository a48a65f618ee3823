"""Nothing under pcabench imports JAX, jaxlib, flax or the JAX package
(top-level names compared whole), and the reference imports nothing of
the program."""
import ast
import pathlib

import pytest

import small

FILES = sorted((small.ROOT / "pcabench").rglob("*.py"))


def imported(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_imports_no_jax_nor_the_jax_package(path):
    assert not set(imported(path)) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted(
    (small.ROOT / "pcabench" / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(imported(path))
