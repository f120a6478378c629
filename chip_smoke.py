"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--json PATH]

Phases (each prints its own lines; any failure exits non-zero):

1. device  — a CUDA card is required; prints its name and power limit;
2. build   — compiles the unit-fold CUDA source (nvcc, sm_90a) and the
             feature-hash Triton kernel from this checkout;
3. kernels — each kernel against its plain PyTorch version on the card,
             at the serving path's shapes (and one offline-shaped
             unit-fold block): bitwise, except the EW lanes at rtol 1e-5;
4. main path — ``FeatureEngine`` on the card at deployment size (1.5 M
             stored rows, capacity 1.6 M), bulk load + 4,096 live rows,
             ``request_batch`` at B = 1, 64, 256; both kernels' launch
             counts must grow; the B = 64 batch must equal a CPU engine
             (plain versions) serving a copy of the same store;
5. times   — request latency percentiles and each kernel's time beside
             its bound and its plain version's time (CUDA events).

The second-to-last line is a JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.  With ``--json PATH`` a
copy of all results (latencies, profile, per-shape kernel times) is
written to PATH.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

SMOKE_SQL = """
SELECT
  sum(price) OVER w AS s, avg(price) OVER w AS a,
  count(price) OVER w AS c, min(price) OVER w AS mn,
  max(price) OVER w AS mx,
  distinct_count(category) OVER w AS dc,
  drawdown(price) OVER wr AS dd,
  ew_avg(price, 0.5) OVER wr AS ew,
  discrete(category, 1048576) AS cat_h
FROM actions
WINDOW w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW),
  wr AS (PARTITION BY userid ORDER BY ts
         ROWS BETWEEN 100 PRECEDING AND CURRENT ROW)
"""

DEPLOYMENT = dict(n_actions=1_000_000, n_orders=500_000, n_users=100,
                  horizon_ms=36_000_000, seed=0, with_profile=False)
CAPACITY = 1_600_000
N_LIVE = 4096
BATCHES = (1, 64, 256)
N_LATENCY = 400                    # timed batches per B (p99 = 4th largest)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
EW_RTOL = 1e-5                     # 1-ulp expf differences carried by a fold


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"== {name}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back runs.

    A wrapper's host work (Python, checks, launches) can take longer than
    its kernels, and then events around a loop time the host.  So the
    stream is first held by a spin kernel (``torch.cuda._sleep``) long
    enough for the host to enqueue all ``reps`` runs; the events then
    bracket device work only."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rtol: float = 0.0) -> float:
    """Exact (rtol 0) or relative comparison, NaN (NULL) only where the
    plain version has NaN; returns max |diff| over the other entries."""
    got, want = got.detach().cpu(), want.detach().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    diff = (got.double() - want.double()).abs().nan_to_num(nan=0.0)
    err = float(diff.max()) if got.numel() else 0.0
    if rtol == 0.0:
        nan = got.isnan()
        ok = torch.equal(nan, want.isnan()) and torch.equal(got[~nan],
                                                            want[~nan])
    else:
        ok = torch.allclose(got, want, rtol=rtol, atol=1e-6, equal_nan=True)
    if not ok:
        raise AssertionError(f"{name}: kernel != plain version "
                             f"(max abs err {err}, rtol {rtol})")
    return err


# ---------------------------------------------------------------- phase 3


def fold_block(members, u: int, r: int, nq: int, seed: int, dev):
    """A (U, R) block of gathered units for one window group, lifted and
    padded exactly as the serving path pads it: sorted timestamps with
    INT_MAX in invalid slots, a valid prefix per unit, queries at the
    last valid row (nq = 1) or every row (nq = R).  Every fourth unit
    holds one NULL (NaN) price, at its last valid row in every other such
    unit, elsewhere at random: min/max/drawdown must propagate it."""
    from repro_torch.kernels.unit_fold import ops, ref
    from repro_torch.core.lowering.windows import (group_leaf_set,
                                                   unique_leaves)

    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 600_000, (u, r)), axis=1).astype(np.int32)
    n_valid = rng.integers(1, r + 1, u)
    valid = np.arange(r)[None, :] < n_valid[:, None]
    ts = np.where(valid, ts, ref.INT_MAX).astype(np.int32)
    price = rng.uniform(1, 100, (u, r)).astype(np.float32)
    nan_units = np.arange(0, u, 4)
    nan_rows = rng.integers(0, n_valid[nan_units])
    nan_rows[::2] = n_valid[nan_units][::2] - 1
    price[nan_units, nan_rows] = np.nan
    env = {"ts": torch.tensor(ts, device=dev),
           "price": torch.tensor(price, device=dev),
           "category": torch.tensor(rng.integers(0, 8, (u, r)),
                                    dtype=torch.float32, device=dev),
           "__valid__": torch.tensor(valid, device=dev)}
    if nq == 1:
        q = torch.tensor(n_valid - 1, dtype=torch.int32, device=dev)[:, None]
    else:
        q = torch.arange(r, dtype=torch.int32, device=dev).expand(u, r)
    plan, idents = ops.plan_for(
        [m.node.spec for m in members], group_leaf_set(members), "ts",
        [tuple(unique_leaves(m.aggs)) for m in members], device=dev)
    data, tsp = ops.pad_rows(
        idents, [ref.lift_group(g, env, (u, r)) for g in plan.groups],
        env["ts"])
    return plan, idents, data, tsp, q.contiguous(), r


def fold_bytes_ops(plan, u: int, rows: int, nq: int):
    """Least bytes (``rows`` rows per unit read once, folds written once)
    and combine operations (structure build + queries) of one fold."""
    levels = max(1, (rows - 1).bit_length())
    cost = {"add": 1, "min": 1, "max": 1, "drawdown": 6, "ew": 8}
    nbytes = u * rows * 4 + u * nq * 4
    ops = 0
    for g in plan.groups:
        mg, f = len(g.members_ix), g.width
        nbytes += u * rows * f * 4 + u * mg * nq * f * 4 + f * 4
        build = (levels * rows if g.kind == "sparse" else rows - 1)
        query = 2 if g.kind == "sparse" else 2 * (levels + 1)
        ops += u * f * cost[g.family] * (build + mg * nq * query)
    return nbytes, ops


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_unit_fold(name, block, reps):
    from repro_torch.kernels.unit_fold.kernel import unit_fold_cuda
    from repro_torch.kernels.unit_fold.ref import unit_fold_plain

    plan, idents, data, ts, q, r_real = block
    got = unit_fold_cuda(plan, data, idents, ts, q, r_real)
    torch.cuda.synchronize()
    want = unit_fold_plain(plan, data, idents, ts, q, r_real)
    err, nulls = 0.0, {}
    for g, a, b in zip(plan.groups, got, want):
        rtol = EW_RTOL if g.family == "ew" else 0.0
        err = max(err, compare(f"unit_fold[{name}/{g.family}]", a, b, rtol))
        nulls[g.family] = int(a.isnan().sum())
    if not all(nulls.values()):
        raise AssertionError(f"unit_fold[{name}]: a group folded no NULL "
                             f"row ({nulls} NaN folds per family)")
    log(f"unit_fold[{name}] NaN (NULL) folds per family, equal to the "
        f"plain version's: {nulls}")
    ms = cuda_ms(lambda: unit_fold_cuda(plan, data, idents, ts, q, r_real),
                 reps)
    plain_ms = cuda_ms(
        lambda: unit_fold_plain(plan, data, idents, ts, q, r_real), 2)
    u, rp = ts.shape
    # the bound counts the R real rows the fold needs; the identity rows
    # that pad each unit to rp are the layout's cost, shown beside it
    b_ms, b_by = bound(*fold_bytes_ops(plan, u, r_real, q.shape[1]))
    padded_ms, _ = bound(*fold_bytes_ops(plan, u, rp, q.shape[1]))
    widths = [f"{g.family}:{g.kind}:{g.width}" for g in plan.groups]
    log(f"unit_fold[{name}] U={u} R={r_real} rp={rp} Q={q.shape[1]} "
        f"groups={widths} max_abs_err={err} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}; "
        f"{padded_ms:.5f} over rows padded to rp)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_padded_rows": padded_ms}


def check_feature_hash(dev, reps):
    from repro_torch.kernels.feature_hash.kernel import feature_hash_triton
    from repro_torch.kernels.feature_hash.ref import feature_hash_ref

    rng = np.random.default_rng(7)
    codes = rng.integers(-2**31, 2**31, 1 << 20, dtype=np.int64)
    codes[:4] = [0, -1, 2**31 - 1, -2**31]
    codes = torch.tensor(codes.astype(np.int32), device=dev)
    dim = 1 << 20
    got = feature_hash_triton(codes, dim)
    want = feature_hash_ref(codes, dim)
    err = compare("feature_hash", got, want)
    ms = cuda_ms(lambda: feature_hash_triton(codes, dim), reps)
    plain_ms = cuda_ms(lambda: feature_hash_ref(codes, dim), 10)
    n = codes.numel()
    b_ms, b_by = bound(8 * n, 12 * n)
    log(f"feature_hash N={n} max_abs_err={err} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def profile_requests(eng, rows, n: int = 5):
    """Device time and kernel count of ``n`` request batches from the
    profiler's kernel events, beside the host wall time they took."""
    from torch.profiler import ProfilerActivity, profile

    eng.request_batch(rows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.request_batch(rows)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    dev_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()),
                  key=lambda kv: -kv[1])[:8]
    return {"wall_ms_per_batch": wall_ms / n,
            "device_ms_per_batch": dev_ms / n,
            "kernels_per_batch": len(kernels) / n,
            "device_busy_share": dev_ms / wall_ms if wall_ms else 0.0,
            "top_kernels_ms_per_batch": [(k[:60], v / 1e3 / n)
                                         for k, v in top],
            "top_host_ops_ms_per_batch": [(k[:60], v / 1e3 / n, c / n)
                                          for k, v, c in host]}


# ---------------------------------------------------------------- phase 4


def slice_table(table, lo: int, hi: int):
    from repro_torch.core.types import Table

    return Table(table.schema, {c: v[lo:hi] for c, v in
                                table.columns.items()}, dicts=table.dicts)


def compare_features(gpu, cpu) -> float:
    err = 0.0
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            if not np.all(np.isfinite(x)):
                raise AssertionError(f"feature {k}[{i}] not finite: {x}")
            if x.shape != y.shape:
                raise AssertionError(f"feature {k}[{i}] shape {x.shape} "
                                     f"!= {y.shape}")
            if k == "ew":
                ok = np.allclose(x, y, rtol=EW_RTOL, atol=1e-6)
            else:
                ok = np.array_equal(x, y)
            if not ok:
                raise AssertionError(f"feature {k}[{i}]: card {x} != "
                                     f"CPU plain path {y}")
            err = max(err, float(np.max(np.abs(x.astype(np.float64) - y))))
    return err


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", dest="json_path", default=None,
                        help="also write all results to this file")
    json_path = parser.parse_args(argv).json_path
    t_start = time.perf_counter()
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.synthetic import make_action_tables
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.feature_hash.kernel import feature_hash_triton
    from repro_torch.kernels.unit_fold.kernel import SOURCE
    from repro_torch.serve.engine import FeatureEngine

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = smi
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    phase("2 build")
    t0 = time.perf_counter()
    build.load_library(SOURCE)                  # nvcc, sm_90a
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    feature_hash_triton(torch.zeros(8, dtype=torch.int32, device=dev), 1024)
    torch.cuda.synchronize()                    # Triton JIT
    t_triton = time.perf_counter() - t0
    lib_path = build.library_path(SOURCE)
    log(f"built {lib_path.name} in {t_nvcc:.1f} s and the Triton kernel "
        f"in {t_triton:.1f} s")
    ptxas = lib_path.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")

    phase("3 kernels against plain versions")
    from repro_torch.core.compiler import compile_script
    from repro_torch.core.lowering.windows import group_windows

    small = make_action_tables(n_actions=64, n_orders=32, n_users=4,
                               horizon_ms=60_000, seed=0,
                               with_profile=False)
    cs = compile_script(SMOKE_SQL, tables=small)
    groups = {g[0].node.spec.name: g for g in group_windows(cs.windows)}
    total = {name: len(g[0].sources) * max(m.online_buffer for m in g) + 1
             for name, g in groups.items()}
    res_w = check_unit_fold("w", fold_block(groups["w"], 256, total["w"],
                                            1, 1, dev), 50)
    res_wr = check_unit_fold("wr", fold_block(groups["wr"], 256,
                                              total["wr"], 1, 2, dev), 50)
    check_unit_fold("offline", fold_block(groups["w"], 64, 1024, 1024, 3,
                                          dev), 5)
    res_fh = check_feature_hash(dev, 50)

    phase("4 main path at deployment size")
    t0 = time.perf_counter()
    tables = make_action_tables(**DEPLOYMENT)
    actions, orders = tables["actions"], tables["orders"]
    n_act = len(actions)
    hist_end = n_act - N_LIVE - max(BATCHES)
    log(f"tables: {n_act} actions + {len(orders)} orders in "
        f"{time.perf_counter() - t0:.1f} s")
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    eng = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                        fused_fold=True, device="cuda")
    eng.bulk_load("actions", slice_table(actions, 0, hist_end))
    eng.bulk_load("orders", orders)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.ingest_many("actions", [actions.row(i) for i in
                                range(hist_end, hist_end + N_LIVE)])
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    stored = eng.store.n_rows("actions") + eng.store.n_rows("orders")
    log(f"bulk_load {stored - N_LIVE} rows in {t_load:.1f} s; ingest_many "
        f"{N_LIVE} rows in {t_ingest:.2f} s; {stored} rows stored")
    reqs = [dict(actions.row(i)) for i in
            range(hist_end + N_LIVE, hist_end + N_LIVE + max(BATCHES))]
    served = {b: eng.request_batch(reqs[:b]) for b in BATCHES}
    counts = dispatch.launch_counts()
    log(f"launches during the main path: {counts}")
    for name in ("unit_fold", "feature_hash"):
        if counts.get(name, 0) < 1:
            raise AssertionError(f"main path did not launch {name}")
    for b, feats in served.items():
        if len(feats) != b or set(feats[0]) != set(cs.feature_names):
            raise AssertionError(f"request_batch B={b}: bad output shape")

    cpu = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                        fused_fold=True, device="cpu")
    cpu.load_store_from({
        t: {"keys": st["keys"].cpu().numpy(), "ts": st["ts"].cpu().numpy(),
            "count": st["count"].cpu().numpy(),
            "cols": {c: v.cpu().numpy() for c, v in st["cols"].items()}}
        for t, st in eng.store.tables.items()})
    err = compare_features(served[64], cpu.request_batch(reqs[:64]))
    log(f"B=64 card vs CPU plain path: equal (bitwise; ew within rtol "
        f"{EW_RTOL}), max abs diff {err}")

    phase("5 times")
    latency = {}
    for b in BATCHES:
        rows = reqs[:b]
        for _ in range(3):
            eng.request_batch(rows)
        # host-inclusive: every call ends by copying features to the host
        samples = []
        for _ in range(N_LATENCY):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eng.request_batch(rows)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        latency[b] = {"p50_ms": float(np.percentile(samples, 50)),
                      "p99_ms": float(np.percentile(samples, 99))}
        log(f"request_batch B={b}: p50 {latency[b]['p50_ms']:.3f} ms, "
            f"p99 {latency[b]['p99_ms']:.3f} ms over {N_LATENCY} batches  "
            f"[{card}]")
    prof = profile_requests(eng, reqs[:256])
    if prof["kernels_per_batch"] == 0:
        log("profiler: no device events (device time not measured)")
    else:
        log(f"profile B=256: wall {prof['wall_ms_per_batch']:.3f} ms, "
            f"device {prof['device_ms_per_batch']:.3f} ms "
            f"({prof['kernels_per_batch']:.0f} kernels), device busy share "
            f"{prof['device_busy_share']:.3f}  [{card}]")
        for name, ms in prof["top_kernels_ms_per_batch"]:
            log(f"  device {ms:.4f} ms  {name}")
        for name, ms, calls in prof["top_host_ops_ms_per_batch"]:
            log(f"  host self {ms:.4f} ms  {calls:.0f} calls  {name}")
    uf = {k: res_w[k] + res_wr[k] for k in ("ms", "plain_ms", "bound_ms")}
    kernels = [
        {"name": "unit_fold", "route": "cuda",
         "source": "src/repro_torch/kernels/unit_fold/csrc/unit_fold.cu",
         "replaces": "src/repro/kernels/unit_fold/kernel.py:278",
         "launches": counts.get("unit_fold", 0),
         "max_abs_err": max(res_w["max_abs_err"], res_wr["max_abs_err"]),
         "ms": uf["ms"], "plain_ms": uf["plain_ms"],
         "bound_ms": uf["bound_ms"], "bound_by": res_w["bound_by"],
         "library_ms": None},
        {"name": "feature_hash", "route": "triton",
         "source": "src/repro_torch/kernels/feature_hash/kernel.py",
         "replaces": "src/repro/kernels/feature_hash/kernel.py:32",
         "launches": counts.get("feature_hash", 0),
         "max_abs_err": res_fh["max_abs_err"], "ms": res_fh["ms"],
         "plain_ms": res_fh["plain_ms"], "bound_ms": res_fh["bound_ms"],
         "bound_by": res_fh["bound_by"], "library_ms": None},
    ]
    log(f"unit_fold main-path shapes (w + wr, B=256): ms {uf['ms']:.4f}, "
        f"plain {uf['plain_ms']:.4f}, bound {uf['bound_ms']:.5f}  [{card}]")
    log(f"feature_hash 2^20 codes: ms {res_fh['ms']:.4f}, plain "
        f"{res_fh['plain_ms']:.4f}, bound {res_fh['bound_ms']:.5f}  "
        f"[{card}]")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if json_path:
        out = pathlib.Path(json_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "card": card, "kernels": kernels, "latency": latency,
            "unit_fold_shapes": {"w": res_w, "wr": res_wr},
            "profile": prof, "load_s": t_load, "ingest_s": t_ingest},
            indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
