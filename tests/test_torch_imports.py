"""Import boundary of the port: nothing under ``src/repro_torch/``
imports JAX or the JAX package ``repro`` (not even its numpy-only
modules: ``repro/core/__init__.py`` pulls in the compiler, which imports
jax)."""

import ast
import pathlib

import pytest

PORT = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted(PORT.rglob("*.py"))


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_has_files():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(PORT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_checker_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom repro.core import types\n"
                 "def g():\n    import jax.numpy as jnp\n")
    assert [r for _, r in _imported_roots(f)] == ["os", "repro", "jax"]
