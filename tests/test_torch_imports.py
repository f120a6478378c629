"""Import boundary of the port: nothing under ``src/repro_torch/``, in
the port's entry points outside ``src/`` (``tools/torch_*.py``,
``examples/torch_*.py``) or in ``chip_smoke.py`` imports JAX or the JAX
package ``repro`` (not even its numpy-only modules:
``repro/core/__init__.py`` pulls in the compiler, which imports jax),
and the entry points do not import the reference gates' helpers
``tools/_common.py`` either."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
# the reference gates' shared module, under both names it is imported by
FORBIDDEN_MODULES = ("tools._common", "_common")
FILES = sorted(PORT.rglob("*.py"))
ENTRY_POINTS = sorted(list((ROOT / "tools").glob("torch_*.py"))
                      + list((ROOT / "examples").glob("torch_*.py"))
                      + [ROOT / "chip_smoke.py"])


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.lineno, node.module


def _imported_roots(path: pathlib.Path):
    for line, name in _imported_modules(path):
        yield line, name.split(".")[0]


# modules of the offline, model-serving, staged-fold, pre-aggregation,
# serving-loop, sharding/replication, row-format / preview / certifier
# / training-data, training, MoE/MLA and device-mesh slices: each must
# exist and import without JAX
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
    "storage.timestore", "core.union", "distributed", "distributed.fault",
    "storage.replication",
    "storage.encoding", "core.preview", "core.analysis",
    "core.analysis.certificate", "core.analysis.consistency_rules",
    "core.analysis.memory", "core.analysis.retrace",
    "core.analysis.sharding", "data.pipeline",
    "train", "train.optimizer", "train.steps", "distributed.compression",
    "launch.train",
    "configs.qwen3_8b", "configs.granite_3_8b", "configs.minicpm3_4b",
    "configs.qwen2_moe_a2_7b", "configs.dbrx_132b",
    "distributed.runtime", "distributed.sharding", "launch.mesh",
    "models.sharded_decode",
    "roofline", "roofline.report", "roofline.trace_analyzer",
    "launch.dryrun")


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


def test_chip_smoke_imports_no_jax_or_reference():
    """``chip_smoke.py`` drives the port on the card, where JAX is not
    installed: it imports neither JAX nor the JAX package."""
    path = PORT.parent.parent / "chip_smoke.py"
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"chip_smoke.py imports {bad}"


def test_entry_points_exist():
    names = {p.name for p in ENTRY_POINTS}
    assert names == {"torch_common.py", "torch_check_consistency.py",
                     "torch_check_replay.py", "torch_check_recovery.py",
                     "torch_analyze_plan.py", "torch_quickstart.py",
                     "torch_online_serving.py", "torch_offline_training.py",
                     "chip_smoke.py"}


@pytest.mark.parametrize("path", ENTRY_POINTS,
                         ids=[p.name for p in ENTRY_POINTS])
def test_entry_point_imports_no_jax_reference_or_common(path):
    """The port's gates, examples and ``chip_smoke.py`` import neither
    JAX, the JAX package nor ``tools/_common.py``."""
    bad = [(line, name) for line, name in _imported_modules(path)
           if name.split(".")[0] in FORBIDDEN
           or any(name == m or name.startswith(m + ".")
                  for m in FORBIDDEN_MODULES)]
    assert not bad, f"{path.name} imports {bad}"


def test_checker_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom repro.core import types\n"
                 "def g():\n    import jax.numpy as jnp\n")
    assert [r for _, r in _imported_roots(f)] == ["os", "repro", "jax"]
    f.write_text("from tools._common import RAW_SQL\nimport _common\n")
    assert [m for _, m in _imported_modules(f)] == ["tools._common",
                                                     "_common"]


# the reference's public names with no port counterpart: they read XLA's
# HLO or stand for JAX / Pallas machinery (ROADMAP.md queue 1)
JAX_ONLY = {"analyze_hlo", "collective_bytes", "PRELIFT_MIN_WIDTH",
            "store_fn", "online_fast_fn", "shard_map_compat",
            "PallasUnsupportedError", "tpu_available", "jax_one_hot"}
REFERENCE = ROOT / "src" / "repro"
PACKAGES = sorted(p.parent.relative_to(REFERENCE)
                  for p in REFERENCE.rglob("__init__.py"))


def _bound_names(path: pathlib.Path):
    """The public names an ``__init__.py`` binds at its top level: its
    imports, functions, classes and assignments."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_every_reference_package_has_a_port():
    assert len(PACKAGES) > 15
    for rel in PACKAGES:
        assert (PORT / rel / "__init__.py").is_file(), rel


@pytest.mark.parametrize("rel", PACKAGES, ids=[str(p) for p in PACKAGES])
def test_package_names_match_the_reference(rel):
    """Every public name a reference package binds in its ``__init__``
    (less the JAX-only ones) is a name of the port's package."""
    dotted = ".".join(("repro_torch",) + rel.parts)
    mod = importlib.import_module(dotted)
    missing = sorted(n for n in _bound_names(REFERENCE / rel / "__init__.py")
                     - JAX_ONLY if not hasattr(mod, n))
    assert not missing, f"{dotted} lacks {missing}"


def test_reexports_that_were_missing():
    """The names ``repro.core``, ``repro.storage`` and ``repro.data``
    re-export that the port's packages once lacked."""
    from repro_torch.core import (AggCall, BinaryOp, ColumnRef, Expr,
                                  FuncCall, Literal, UnaryOp, cache_stats,
                                  clear_cache)
    from repro_torch.data import make_clicks_table
    from repro_torch.storage import estimate_memory

    assert Expr.__module__ == "repro_torch.core.expr"
    assert all(issubclass(c, Expr) for c in (AggCall, BinaryOp, ColumnRef,
                                             FuncCall, Literal, UnaryOp))
    assert callable(cache_stats) and callable(clear_cache)
    assert estimate_memory.__module__ == "repro_torch.storage.memest"
    assert make_clicks_table.__module__ == "repro_torch.data.synthetic"
