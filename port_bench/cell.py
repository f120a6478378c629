"""One cell, found by name: its workload file, configuration, traffic mix,
driver, reference and per-layer metric readers, each a file of its own
under ``port_bench/`` that ``BENCHMARK.json`` and the workload file name.

  workloads/<cell>.json   the configuration, the traffic, chips, limits
  configs/<config>.json   the program's arch name, every size, dtypes,
                          the optimizer, the family of the reference
  traffic/<mix>.json      the traffic kind (a module of ``drivers``) and
                          its parameters
  reference/<family>.py   the plain reference and the weights' layout
  metrics/<metric>.py     ``read(run) -> number or None`` per metric
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import judge
from .profiling import Spans

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
OUT_DIR = ROOT / "build" / "port_bench"


def read_json(path: pathlib.Path) -> Dict:
    return json.loads(path.read_text())


def benchmark() -> Dict:
    return read_json(ROOT / "BENCHMARK.json")


# what the program's ArchConfig must hold for each size of a config file
_ARCH_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab_size", "vocab_padded", "head_dim", "rope_theta",
                "norm_eps", "sliding_window", "global_attn_every")
_SUB_FIELDS = {"ssm_state_dim": ("ssm", "state_dim"),
               "ssm_expand": ("ssm", "expand"),
               "q_rank": ("mla", "q_rank"), "kv_rank": ("mla", "kv_rank"),
               "rope_dim": ("mla", "rope_dim"),
               "nope_dim": ("mla", "nope_dim"), "v_dim": ("mla", "v_dim")}


def arch_mismatch(cfg: Dict, arch) -> List[str]:
    """Sizes of the configuration file that the program's config does not
    hold (a size the file leaves out is not checked)."""
    bad = []
    for k in _ARCH_FIELDS:
        if k in cfg and getattr(arch, k) != cfg[k]:
            bad.append(f"{k}: file {cfg[k]}, program {getattr(arch, k)}")
    for k, (group, field) in _SUB_FIELDS.items():
        if k in cfg:
            got = getattr(getattr(arch, group), field, None)
            if got != cfg[k]:
                bad.append(f"{k}: file {cfg[k]}, program {got}")
    return bad


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict          # the workload file
    cfg: Dict            # the configuration file
    traffic: Dict        # the traffic file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    arch: Any            # the program's ArchConfig
    ref: Any             # the reference module
    layout: Dict
    driver: Any
    span: Spans

    def free(self) -> None:
        """Let the card's memory go once the program's state is dropped."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def make(name: str, seed: int, seconds: float, trace: bool) -> Cell:
    """The cell ``name`` of the benchmark, from its files."""
    entry = read_json(BENCH_DIR / "workloads" / f"{name}.json")
    cfg = read_json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    traffic = read_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    from repro_torch.configs import get
    return build(name, entry, cfg, traffic, get(cfg["arch"]), seed,
                 seconds, trace, "cuda")


def build(name: str, entry: Dict, cfg: Dict, traffic: Dict, arch,
          seed: int, seconds: float, trace: bool, device: str) -> Cell:
    """A cell from its workload entry, configuration, traffic and the
    program's config (the CPU tests build cells at tiny sizes)."""
    bad = arch_mismatch(cfg, arch)
    if bad:
        raise ValueError(f"configuration {entry['config']} is not the "
                         f"program's {arch.name}: " + "; ".join(bad))
    ref = importlib.import_module(f"port_bench.reference.{cfg['reference']}")
    return Cell(name=name, entry=entry, cfg=cfg, traffic=traffic,
                seed=int(seed), seconds=float(seconds), trace=bool(trace),
                device=torch.device(device), arch=arch, ref=ref,
                layout=ref.layout(cfg),
                driver=importlib.import_module(
                    f"port_bench.drivers.{traffic['kind']}"),
                span=Spans(bool(trace)))


def metrics_of(bench: Dict, name: str) -> Tuple[List[Dict], List[Dict]]:
    """The end-to-end and per-layer metrics ``BENCHMARK.json`` gives the
    cell ``name``."""
    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and m["moves"] in names]
    return e2e, layer


def load_reader(metric: str):
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads."""
    cfg: Dict
    traffic: Dict
    trace: Any
    work: Dict


def execute(cell: Cell, started: float, bench: Optional[Dict] = None
            ) -> Dict:
    """Run the cell once; returns the result line (``checks`` last)."""
    bench = bench or benchmark()
    e2e, layer = metrics_of(bench, cell.name)
    out = cell.driver.run(cell)
    metrics: Dict[str, Dict] = {}
    if cell.trace:
        run = Run(cell.cfg, cell.traffic, out["trace"], out.get("work", {}))
        for m in layer:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        got = dict(out["e2e"], setup_s=out["setup_end"] - started)
        for m in e2e:
            if m["name"] not in got:
                raise KeyError(f"the {cell.traffic['kind']} driver gives "
                               f"no {m['name']}")
            metrics[m["name"]] = {"value": got[m["name"]], "unit": m["unit"]}
    rows = judge.checks(out["numbers"], cell.entry["limits"])
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if cell.device.type == "cuda" else "cpu"),
              "count": cell.entry["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": judge.passed(rows), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if cell.trace:
        device["busy_s"] = out["trace"].busy_s
        device["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown()
    result["checks"] = {n: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for n, v, lim in rows}
    keep(cell, out, result)
    return result


def keep(cell: Cell, out: Dict, result: Dict) -> None:
    """A run's summary beside its build, inside the checkout."""
    record = {"cell": cell.name, "seed": cell.seed, "trace": cell.trace,
              "result": result, "numbers": out["numbers"],
              "work": out.get("work"), "readings": out.get("readings"),
              "at": time.time()}
    if cell.trace:
        record["trace"] = out["trace"].summary()
    try:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        path = OUT_DIR / f"{cell.name}.{cell.seed}.{int(cell.trace)}.json"
        path.write_text(json.dumps(record, indent=1, default=str))
    except OSError as e:
        print(f"port_bench: summary not kept: {e}", file=sys.stderr)
