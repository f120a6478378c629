"""Readings that set a cell's limits, on the card at the cell's own size:
the program, the control (the plain reference with its products in
float8 e4m3, put in the program's place) and the faults the cell's
driver plants (its ``FAULTS``), each against the f32 reference, on
several seeds in one process:

    python3 port_bench/control.py --workload <cell> --seeds 11,12,13 \
        --variants program,program@float32,control,half_batch

``program@<dtype>`` runs the program computing in ``<dtype>`` instead of
the configuration's compute dtype.  One JSON line per (seed, variant):
the numbers the cell compares, each beside its limit in the workload
file, and whether they pass.  The cell's driver module gives the
reference (``control_reference``) and each variant's numbers
(``control_numbers``).  The benchmark's own runs never run this.
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def keep(name, seed, variant, got, ref):
    """Per-leaf readings beside the runs' summaries."""
    from port_bench import cell as cells
    cells.OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = cells.OUT_DIR / f"control.{name}.{seed}.{variant}.json"
    path.write_text(json.dumps({"variant": variant, "readings": got,
                                "reference": ref}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program,control")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from port_bench import cell as cells
    from port_bench import judge

    for seed in [int(s) for s in args.seeds.split(",")]:
        cell = cells.make(args.workload, seed, 0, False)
        t0 = time.perf_counter()
        ref = cell.driver.control_reference(cell)
        ref_s = time.perf_counter() - t0
        for variant in args.variants.split(","):
            t1 = time.perf_counter()
            name, _, dtype = variant.partition("@")
            run = cell if not dtype else dataclasses.replace(
                cell, cfg=dict(cell.cfg, compute_dtype=dtype))
            nums, got = cell.driver.control_numbers(run, name, ref)
            rows = judge.checks(nums, cell.entry["limits"])
            print(json.dumps({
                "cell": args.workload, "seed": seed, "variant": variant,
                "passed": judge.passed(rows),
                "checks": {n: {"value": v if math.isfinite(v) else None,
                               "limit": lim} for n, v, lim in rows},
                "numbers": nums, "reference_s": ref_s,
                "variant_s": time.perf_counter() - t1}), flush=True)
            if got is not None:
                keep(args.workload, seed, variant, got, ref)
        del ref
        cell.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
