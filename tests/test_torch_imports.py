"""Import boundary of the port: nothing under ``src/repro_torch/``
imports JAX or the JAX package ``repro`` (not even its numpy-only
modules: ``repro/core/__init__.py`` pulls in the compiler, which imports
jax)."""

import ast
import importlib
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


# modules of the offline, model-serving, staged-fold, pre-aggregation and
# serving-loop slices: each must exist and import without JAX
SLICE_MODULES = (
    "core.hll", "core.skew", "core.multiwindow", "core.consistency",
    "core.window", "core.preagg",
    "core.lowering.windows", "core.lowering.joins", "core.lowering.drivers",
    "kernels.batch_windowfold", "kernels.batch_windowfold.ref",
    "kernels.batch_windowfold.kernel", "kernels.batch_windowfold.ops",
    "kernels.segagg", "kernels.segagg.ref", "kernels.segagg.kernel",
    "kernels.segagg.ops",
    "configs", "configs.base", "configs.registry", "configs.hymba_1_5b",
    "configs.llama3_8b",
    "kernels.chunked_scan", "kernels.chunked_scan.ref",
    "kernels.chunked_scan.kernel", "kernels.chunked_scan.ops",
    "kernels.flash_decode", "kernels.flash_decode.ref",
    "kernels.flash_decode.kernel", "kernels.flash_decode.ops",
    "models", "models.layers", "models.model", "serve.engine",
    "launch", "launch.serve",
    "serve.clock", "serve.loop", "serve.trace", "storage.memest",
    "storage.timestore")


def test_port_has_files():
    assert len(FILES) > 20
    have = {".".join(p.relative_to(PORT).with_suffix("").parts)
            for p in FILES}
    for m in SLICE_MODULES:
        assert m in have or m + ".__init__" in have, m
    for pkg, src in (("batch_windowfold", "batch_windowfold"),
                     ("segagg", "segagg"), ("unit_fold", "unit_fold"),
                     ("chunked_scan", "linear_scan"),
                     ("flash_decode", "flash_decode")):
        assert (PORT / "kernels" / pkg / "csrc" / f"{src}.cu").is_file()


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_imports_without_jax(module):
    """The module imports, and nothing it binds comes from JAX or the
    reference package."""
    mod = importlib.import_module(f"repro_torch.{module}")
    assert mod.__doc__
    foreign = [name for name, v in vars(mod).items()
               if str(getattr(v, "__module__", None) or
                      getattr(v, "__name__", "")).split(".")[0]
               in FORBIDDEN]
    assert not foreign, foreign


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
