"""Tiny cells for the CPU tests: the program's ``reduced`` configs of the
benchmark's architectures, and small traffic of each driver kind."""

from __future__ import annotations

import copy
from typing import Dict

from port_bench import cell as cells


def cfg_of(arch, base: Dict) -> Dict:
    """The configuration file ``base`` with the sizes of ``arch``."""
    cfg = copy.deepcopy(base)
    for k in cells._ARCH_FIELDS:
        if k in cfg:
            cfg[k] = getattr(arch, k)
    for k, (group, field) in cells._SUB_FIELDS.items():
        if k in cfg:
            cfg[k] = getattr(getattr(arch, group), field)
    return cfg


TRAFFIC = {
    "train": {"kind": "train", "batch": 4, "seq_len": 24, "n_micro": 2,
              "trace_steps": 1},
    "prefill": {"kind": "prefill", "trace_cycles": 1, "check_extra": 2,
                "classes": [{"seq": 16, "rows": 2, "per_cycle": 2},
                            {"seq": 32, "rows": 1, "per_cycle": 1}]},
}

# Each tiny cell: its configuration file and driver kind.  A cell of the
# benchmark takes the limits of its workload file; the prefill kind, which
# no cell of the benchmark runs yet, a bar that f32 rounding at these
# sizes clears by far (its sound numbers read under 1e-5).
CASES = {"hymba-1.5b.train": ("hymba-1.5b", "train"),
         "minicpm3-4b.prefill": ("minicpm3-4b", "prefill")}
PREFILL_LIMITS = {"token_gap": 1e-3, "logit_err": 1e-3, "state_err": 1e-3}


def tiny_cell(name: str, seed: int = 5, seconds: float = 0.0):
    from repro_torch.configs import get, reduced

    config, kind = CASES[name]
    base = cells.read_json(cells.BENCH_DIR / "configs" / f"{config}.json")
    arch = reduced(get(base["arch"]).name)
    path = cells.BENCH_DIR / "workloads" / f"{name}.json"
    entry = (cells.read_json(path) if path.is_file() else
             {"config": config, "traffic": kind, "chips": 1,
              "limits": PREFILL_LIMITS})
    return cells.build(name, entry, cfg_of(arch, base),
                       copy.deepcopy(TRAFFIC[kind]), arch, seed, seconds,
                       False, "cpu")
