"""Run one cell of the port's benchmark once:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up, a measured window of ``--seconds`` (``--trace 1``: a profiled
window, the per-layer metrics), then the check against the plain
reference; the last line of standard output is one JSON object, the
numbers compared each beside its limit on the last lines of standard
error.  Exits with 2, printing no result, without enough CUDA cards for
the cell, and with 3 if JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from port_bench import cell as cells

    bench = cells.benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA "
              f"device(s); this machine has {cards}", file=sys.stderr)
        return 2
    c = cells.make(args.workload, args.seed, args.seconds, bool(args.trace))
    result = cells.execute(c, STARTED, bench)
    bad = loaded_forbidden()
    if bad:
        print(f"modules of {bad} were loaded in this process",
              file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
