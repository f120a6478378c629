"""``BENCHMARK.json`` against the benchmark's contract, each cell against
its files, and the modules the harness loads."""

import json
import os
import re
import subprocess
import sys

import pytest

from port_bench import cell as cells

BENCH = cells.read_json(cells.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 338 * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"])
                for w in BENCH["workloads"]}) == len(CELLS)


def test_files_under_paths_are_named_from_name_characters():
    for root in BENCH["paths"]:
        for p in (cells.ROOT / root).rglob("*"):
            if "__pycache__" in p.parts:
                continue
            rel = p.relative_to(cells.ROOT).as_posix()
            assert PATH.match(rel), rel


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_resolves_to_its_files(name):
    w = next(x for x in BENCH["workloads"] if x["name"] == name)
    entry = cells.read_json(cells.BENCH_DIR / "workloads" / f"{name}.json")
    assert {k: entry[k] for k in ("config", "traffic", "chips")} == {
        k: w[k] for k in ("config", "traffic", "chips")}
    assert entry["limits"]
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    cfg = cells.read_json(cells.ROOT / conf["file"])
    assert any(conf["file"].startswith(p + "/") for p in BENCH["paths"])
    assert cfg["reduced"] == conf["reduced"] and cfg["source"] == \
        conf["source"]
    traffic = cells.read_json(cells.BENCH_DIR / "traffic"
                              / f"{w['traffic']}.json")
    for mod in (f"drivers/{traffic['kind']}.py",
                f"reference/{cfg['reference']}.py"):
        assert (cells.BENCH_DIR / mod).is_file(), mod
    e2e, layer = cells.metrics_of(BENCH, name)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert (cells.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in
                                  cells.metrics_of(BENCH, cell)[0]}
    from repro_torch.configs import get
    assert cells.arch_mismatch(cfg, get(cfg["arch"])) == []


def test_configs_are_used_and_files_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


_WALK = r"""
import importlib, importlib.util, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
bench = root / "port_bench"
for p in sorted(bench.rglob("*.py")):
    if "tests" in p.parts or p.name == "run.py":
        continue
    rel = p.relative_to(root).with_suffix("")
    if "." in p.stem:
        spec = importlib.util.spec_from_file_location("m_" + p.stem.replace(
            ".", "_"), p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(".".join(rel.parts).replace(".__init__", ""))
if sys.argv[2] == "program":
    import repro_torch.serve.engine, repro_torch.train.steps  # the drivers'
    spec = importlib.util.spec_from_file_location("pb_run", bench / "run.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(kind):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _WALK, str(cells.ROOT),
                          kind], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    return set(out.stdout.split())


def test_nothing_loaded_is_jax_or_the_jax_package():
    """Top-level names compared whole: ``repro_torch`` is the port,
    ``repro`` the JAX package."""
    names = _top_level("program")
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_program():
    names = _top_level("harness")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_run_refuses_without_cards(tmp_path):
    """Without a card the command exits non-zero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, str(cells.BENCH_DIR / "run.py"), "--workload",
         CELLS[0], "--seed", str(2**31 + 7), "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, env=env, timeout=120,
        cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
