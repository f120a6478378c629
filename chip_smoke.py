"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--json PATH]

Phases (each prints its own lines; any failure exits non-zero):

1. device  — a CUDA card is required; prints its name and power limit;
2. build   — compiles the five CUDA sources (unit fold, batched window
             fold, segmented sums, linear scan, flash decode; nvcc,
             sm_90a), one nvcc each, all started together, and the
             feature-hash Triton kernel, from this checkout;
3. kernels — each kernel against its plain PyTorch version on the card,
             at its paths' shapes, and run twice (the two runs must be
             bitwise equal): the unit fold on unpadded rows at the
             serving shapes (B = 256, few-query variant), at the
             consistency replay's U = 1, and at Q = rp offline shapes of
             rp 2,048 (shared-memory variant) to 32,768 (wide
             global-memory variant), bitwise except the EW lanes at
             rtol 1e-5; the feature hash, exact; and, once the serving
             store exists (3b, after phase 4), the batched window fold on
             it (rtol/atol 1e-5, a NaN row that matches no request, a
             +Inf row that request 0 matches) and
             the bucket build over the deployment's action rows
             (rtol 1e-4, NaN prices, out-of-range ids; the segmented-sum
             kernel, its plain version and one ``index_add_`` timed on
             the same prepared inputs at both widths, the kernel's passes
             by name under the profiler); 3c, the model
             kernels at the full hymba-1.5b shapes: the linear scan at
             (8, 1024, 51,200) float32, bitwise, and the decode partials
             at B = 8, Hq = 25, Hkv = 5, D = 64 over a bf16 cache of
             2,048 (live ranges from 0 and, as on a sliding-window layer,
             from lo > 0), rtol 1e-4 / atol 1e-5, timed warm (one cache)
             and cold in L2 (a rotation of eight caches), beside one
             ``scaled_dot_product_attention`` call;
4. main paths, each with the launch counts set to 0 just before it and
             read just after, at deployment size (1.5 M rows; run in
             the order a, b, e, f, g, c, d):
   a. serving — ``FeatureEngine`` (capacity 1.6 M) bulk load + 4,096 live
             rows, ``request_batch`` at B = 1, 64, 256; the B = 64 batch
             must equal a CPU engine (plain versions) on a copy of the
             store;
   b. offline — ``FeatureEngine.offline()`` over the deployment tables,
             equal to the same call with the plain fold on the card
             (``unit_fold_kernel=False``); the same on a skewed (zipf 1.1)
             variant, whose hot keys' units take the wide variant; then
             ``verify_consistency(bitwise=True)`` on the card over a
             prefix of the tables (every base row replayed as a request);
   e. staged fold — ``FeatureEngine(fused_fold=False)`` on a copy of
             4a's store: ``request_batch`` at B = 1, 64, 256 and
             ``request`` equal 4a's fused features (bitwise, ew at rtol
             1e-5), staged ``offline()`` equals 4b's, and the seed
             baseline (``run_reference_serial``) equals it (counts,
             min/max, hash bitwise; sums within a float32 bound of the
             key history's prefix; the rest at rtol 1e-4 / atol 1e-3)
             and its own CPU run; timed;
   f. long windows — ``LONG_SQL`` (``OPTIONS(long_windows="wl:60s")``)
             over 1.5 M rows of 32 keys, ``use_preagg=True``: bulk load
             and ``ingest_many`` maintain the bucket planes (checked
             against the same folds alone, timed), ``request_batch`` at
             B = 1, 64, 256 equals a CPU engine on copies of the store
             and planes (bitwise, drawdown and EW at rtol 1e-5) and the
             first request equals ``offline()`` over its history; then
             ``verify_consistency(use_preagg=True)`` over every 300th
             row, the reference certifier's bitwise columns bitwise;
   g. serving loop — a retention engine (``retention="auto"``,
             ``compact_every=256``: orders keep 60 s, actions all) with
             both tables bulk-loaded below one time cut and the rows
             after it streamed in ts order: (a) a snapshot serves B = 64
             byte-identically across an ``ingest_many`` that compacts
             orders to its last 60 s, and after ``refresh()`` equals
             a CPU engine on copies of the store and, within the prefix
             bound on the sums, a card engine without retention; (b)
             ``ServeLoop`` under ``SystemClock``: 2,000 open-loop Poisson
             arrivals through a deadline and a count-only loop, then 100
             waves of 64 requests + 64 streamed rows (TP50/99/999,
             resident rows and binlog bounded, one flush's launches and
             busy share); (c) a trace recorded on a CPU engine replays on
             the card with equal bytes and final store; (d)
             ``record_consistency_trace`` over a prefix (integer prices,
             mid-trace eviction) holds ``verify_consistency(bitwise=
             True)`` and replays bitwise;
   c. additive folds — ``store_windowfold`` on the serving store at
             B = 1, 64, 256 and ``bucket_build`` over the action rows;
   d. model serving — hymba-1.5b at full width and depth (random
             weights from a seeded ``torch.Generator``), ``ServingEngine``
             with B = 8 prompts of 1,024 tokens, ``max_len`` 2,048,
             ``generate_greedy`` 32 tokens: in float32 through the
             kernels, then teacher-forced through the kernels and the
             plain versions (prefill and every step's logits within
             rtol/atol 1e-3); then in bf16, timed (prefill, decode per
             token, tokens/s, device busy share under the profiler);
5. times   — request latency percentiles, offline wall and device time,
             and each kernel's time beside its bound, its plain version's
             time and, where one exists, one PyTorch call's (CUDA events).

The second-to-last line is a JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.  With ``--json PATH`` a
copy of all results (latencies, profiles, per-shape kernel times) is
written to PATH.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import itertools
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
SKEW_ALPHA = 1.1                   # zipf skew of the offline variant
CONSISTENCY_ROWS = 20_000          # replayed rows (one request per base row)
WINDOW_MS = 60_000                 # additive folds' request frame
BUCKETS = ((60_000, 600), (1_000, 36_000))   # bucket_build (ms, buckets)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
EW_RTOL = 1e-5                     # 1-ulp expf differences carried by a fold
MODEL_ARCH = "hymba-1.5b"          # model serving (phase 4d), full size
MODEL_BATCH, MODEL_PROMPT, MODEL_MAX_LEN, MODEL_TOKENS = 8, 1024, 2048, 32
MODEL_TOL = 1e-3                   # f32 logits, kernels vs plain versions
DECODE_LIVE = (1025, 1056)         # decode live lengths at positions 1,024+
DECODE_COLD = 8                    # caches rotated for the cold-L2 times
STAGED_REPS = 100                  # timed batches per B, phases 4e and 4f
SEED_TOL = dict(rtol=1e-4, atol=1e-3)   # reduction-order bar (reference)
# the seed baseline sums a window as the difference of two float32
# prefixes over the key's whole history, so its error scales with that
# history's magnitude S, not with the window's value: |diff| <= atol +
# SEED_PREFIX_ULPS * 2^-24 * S for the additive columns
SEED_PREFIX_ULPS = 16
SEED_ADDITIVE = ("s", "a")

# phase 4f: the serving deployment's rows and horizon with 32 keys, the
# most an integer key without a dictionary gets planes for (rule
# C-KEYCARD: the compile-time cardinality is 32), and a long window
LONG_SQL = """
SELECT
  sum(price) OVER wl AS s_l, count(price) OVER wl AS c_l,
  min(price) OVER wl AS mn_l, max(price) OVER wl AS mx_l,
  distinct_count(category) OVER wl AS dc_l,
  drawdown(price) OVER wl AS dd_l, ew_avg(price, 0.5) OVER wl AS ew_l,
  sum(price) OVER w AS s, count(price) OVER w AS c,
  discrete(category, 1048576) AS cat_h
FROM actions
WINDOW wl AS (UNION orders PARTITION BY userid ORDER BY ts
              ROWS_RANGE BETWEEN 36000s PRECEDING AND CURRENT ROW),
       w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "wl:60s")
"""
DEPLOYMENT_LONG = dict(n_actions=1_000_000, n_orders=500_000, n_users=32,
                       horizon_ms=36_000_000, seed=0, with_profile=False)
# (keys, fine slots, coarse slots, max_coarse_q, max_bucket_rows): what
# the reference builds for LONG_SQL
LONG_PLANES = (32, 632, 41, 39, 128)
LONG_LOOSE = ("dd_l", "ew_l")      # card vs CPU: rtol 1e-5 (EW, drawdown)
LONG_EXACT_OFFLINE = ("c_l", "mn_l", "mx_l", "dc_l")
GATE_STRIDE = 300                  # the pre-agg gate replays every 300th row
# the reference certifier's bitwise class under pre-agg for LONG_SQL over
# the thinned tables (no C-BUF, C-PREAGG-EDGE or C-KEYCARD there); the
# other columns take the reference's tolerance
GATE_BITWISE = ("c_l", "mn_l", "mx_l", "dc_l", "s", "c", "cat_h")

# phase 4g: the serving loop over the serving deployment with retention.
# Both tables are bulk-loaded below one time cut (8,448 action rows
# before the end) and the rows after it stream in ts order.
LOOP_STREAM = 2 * N_LIVE + max(BATCHES)   # action rows after the cut
COMPACT_EVERY = 256
RETAINED = {"actions": None, "orders": WINDOW_MS}   # wr is a ROWS frame
SNAP_ROWS = 1024           # (a) streamed rows: at least one orders tick
LOOP_BATCH, LOOP_WAIT_MS, LOOP_SLO_MS = 64, 5.0, 25.0
LOOP_SPARSE = 2000         # (b) open-loop requests per batching policy
LOOP_WAVES = 100           # (b) closed loop: waves of 64 requests + 64 rows
TRACE_HISTORY_MS = 20 * 60_000   # (c) history the trace's engines load
TRACE_CAPACITY = 65_536
TRACE_ROWS = 1_600         # (c) streamed rows: two orders ticks or more
GATE_LOOP_ROWS = 3_000     # (d) prefix events; past 60 s, so rows evict
GATE_LOOP_COMPACT = 64


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
            rtol: float = 0.0, atol: float = 1e-6) -> float:
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
        ok = torch.allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    if not ok:
        raise AssertionError(f"{name}: kernel != plain version "
                             f"(max abs err {err}, rtol {rtol})")
    return err


def same_bits(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Two runs of one kernel on the same inputs: the same bits (NaN at
    the same places)."""
    if not (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num())):
        raise AssertionError(f"{name}: two runs differ")


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 2


def build_all(dev):
    """One nvcc per CUDA source, all started together, beside the Triton
    JIT; returns {source name: seconds}."""
    from repro_torch.kernels import build
    from repro_torch.kernels.batch_windowfold.kernel import SOURCE as BWF
    from repro_torch.kernels.chunked_scan.kernel import SOURCE as LS
    from repro_torch.kernels.feature_hash.kernel import feature_hash_triton
    from repro_torch.kernels.flash_decode.kernel import SOURCE as FD
    from repro_torch.kernels.segagg.kernel import SOURCE as SEG
    from repro_torch.kernels.unit_fold.kernel import SOURCE as UF

    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    def triton_jit():
        feature_hash_triton(torch.zeros(8, dtype=torch.int32, device=dev),
                            1024)
        torch.cuda.synchronize()

    sources = (UF, BWF, SEG, LS, FD)
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        jobs = {src.name: pool.submit(timed, build.load_library, src)
                for src in sources}
        jobs["triton feature_hash"] = pool.submit(timed, triton_jit)
        took = {name: job.result() for name, job in jobs.items()}
    for src in sources:
        lib = build.library_path(src)
        log(f"built {lib.name} in {took[src.name]:.1f} s")
        log_path = lib.with_suffix(".log")
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas: {line.strip()}")
    log(f"Triton feature_hash JIT in {took['triton feature_hash']:.1f} s")
    return took


# ---------------------------------------------------------------- phase 3


def fold_block(members, u: int, r: int, nq: int, seed: int, dev):
    """A (U, R) block of gathered units for one window group, lifted as
    the serving path lifts it (unpadded: the kernel makes the identity
    rows past R itself): sorted timestamps with INT_MAX in invalid
    slots, a valid prefix per unit, queries at the last valid row
    (nq = 1) or every row (nq = R).  Every fourth unit holds one NULL
    (NaN) price, at its last valid row in every other such unit,
    elsewhere at random: min/max/drawdown must propagate it (a U = 1
    block: its unit holds the NULL)."""
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
    data = [ref.lift_group(g, env, (u, r)).contiguous() for g in plan.groups]
    return plan, idents, data, env["ts"].contiguous(), q.contiguous()


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


def check_unit_fold(name, block, reps):
    """The kernel on the unpadded block against the plain version on the
    block padded to rp (``ops.pad_rows``, timed with it): bitwise except
    EW at rtol 1e-5, two runs bitwise, NaN folds at the same places."""
    from repro_torch.kernels.unit_fold import ops
    from repro_torch.kernels.unit_fold.kernel import unit_fold_cuda, variant
    from repro_torch.kernels.unit_fold.ref import unit_fold_plain

    plan, idents, data, ts, q = block
    u, r = ts.shape
    kind = variant(plan, r, q.shape[1])

    def plain():
        pdata, pts = ops.pad_rows(idents, data, ts)
        return unit_fold_plain(plan, pdata, idents, pts, q, r)

    got = unit_fold_cuda(plan, data, idents, ts, q)
    again = unit_fold_cuda(plan, data, idents, ts, q)
    torch.cuda.synchronize()
    want = plain()
    err, nulls = 0.0, {}
    for g, a, b, c in zip(plan.groups, got, want, again):
        same_bits(f"unit_fold[{name}/{g.family}]", a, c)
        rtol = EW_RTOL if g.family == "ew" else 0.0
        err = max(err, compare(f"unit_fold[{name}/{g.family}]", a, b, rtol))
        nulls[g.family] = int(a.isnan().sum())
    if not all(nulls.values()):
        raise AssertionError(f"unit_fold[{name}]: a group folded no NULL "
                             f"row ({nulls} NaN folds per family)")
    log(f"unit_fold[{name}] {kind} variant; NaN (NULL) folds per family, "
        f"equal to the plain version's: {nulls}; two runs equal")
    ms = cuda_ms(lambda: unit_fold_cuda(plan, data, idents, ts, q), reps)
    plain_ms = cuda_ms(plain, 2)
    rp = max(2, 1 << (r - 1).bit_length())
    # the bound counts the R real rows the fold needs; the identity rows
    # that pad each unit to rp are the plain layout's cost, shown beside it
    b_ms, b_by = bound(*fold_bytes_ops(plan, u, r, q.shape[1]))
    padded_ms, _ = bound(*fold_bytes_ops(plan, u, rp, q.shape[1]))
    widths = [f"{g.family}:{g.kind}:{g.width}" for g in plan.groups]
    log(f"unit_fold[{name}] U={u} R={r} rp={rp} Q={q.shape[1]} "
        f"groups={widths} max_abs_err={err} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}; "
        f"{padded_ms:.5f} over rows padded to rp)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "variant": kind,
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


def store_vals(state) -> torch.Tensor:
    """The additive lanes (price, 1) lifted from a store table state."""
    price = state["cols"]["price"]
    return torch.stack([price, torch.ones_like(price)], dim=1).contiguous()


def request_frames(reqs, dev):
    """(key, [ts - WINDOW_MS, ts]) of request rows, int32 on ``dev``."""
    key = torch.tensor([int(r["userid"]) for r in reqs], dtype=torch.int32,
                       device=dev)
    t1 = torch.tensor([int(r["ts"]) for r in reqs], dtype=torch.int32,
                      device=dev)
    return key, t1 - WINDOW_MS, t1


def matched_row(state, key: int, t0: int, t1: int) -> int:
    """A live store row that the request (key, [t0, t1]) matches."""
    n = int(state["count"])
    keys = state["keys"][:n].cpu().numpy()
    ts = state["ts"][:n].cpu().numpy()
    hit = np.flatnonzero((keys == key) & (ts >= t0) & (ts <= t1))
    if hit.size == 0:
        raise AssertionError(f"no live row matches request key {key}")
    return int(hit[0])


def check_batch_windowfold(state, reqs, dev, reps):
    """``store_windowfold`` on the serving store (C = capacity) at each
    request batch: kernel against plain version (rtol/atol 1e-5), twice
    bitwise; then a NaN in a live row that no request matches (row 0,
    in a chunk every request's range misses), which (as in the
    reference's dense product) turns its whole lane NaN; then a +Inf in a
    live row that request 0 matches: that request's lane is +Inf, not
    NaN, and every other request's is Inf (it matches too) or NaN (the
    dense product's 0 * Inf)."""
    from repro_torch.kernels.batch_windowfold import store_windowfold

    vals = store_vals(state)
    count = int(state["count"])
    out, err = {}, 0.0
    for b in BATCHES:
        q = request_frames(reqs[:b], dev)
        got = store_windowfold(state, vals, *q, use_kernel=True)
        again = store_windowfold(state, vals, *q, use_kernel=True)
        torch.cuda.synchronize()
        same_bits(f"batch_windowfold[B={b}]", got, again)
        want = store_windowfold(state, vals, *q, use_kernel=False)
        err = max(err, compare(f"batch_windowfold[B={b}]", got, want,
                               rtol=1e-5, atol=1e-5))
        if got.isnan().any():
            raise AssertionError(f"batch_windowfold[B={b}]: NaN folds")
        out[b] = q
    q = out[max(BATCHES)]
    nan_vals = vals.clone()
    nan_vals[0, 0] = float("nan")         # row 0 lies before every frame
    got = store_windowfold(state, nan_vals, *q, use_kernel=True)
    want = store_windowfold(state, nan_vals, *q, use_kernel=False)
    compare("batch_windowfold[NaN row]", got, want, rtol=1e-5, atol=1e-5)
    if not (got[:, 0].isnan().all() and not got[:, 1].isnan().any()):
        raise AssertionError("batch_windowfold: a NaN in an unmatched row "
                             "must turn exactly its lane NaN")
    inf_vals = vals.clone()
    inf_vals[matched_row(state, int(q[0][0]), int(q[1][0]),
                         int(q[2][0])), 0] = float("inf")
    got = store_windowfold(state, inf_vals, *q, use_kernel=True)
    want = store_windowfold(state, inf_vals, *q, use_kernel=False)
    compare("batch_windowfold[Inf row]", got, want, rtol=1e-5, atol=1e-5)
    lane = got[:, 0]
    if not (bool(lane[0] == float("inf"))
            and bool((lane.isnan() | (lane == float("inf"))).all())
            and bool(torch.isfinite(got[:, 1]).all())):
        raise AssertionError("batch_windowfold: a +Inf in a matched row "
                             "must give +Inf to its request, NaN or Inf "
                             "to the others in its lane only")
    log(f"batch_windowfold: kernel == plain (rtol 1e-5) at B={BATCHES} "
        f"over C={vals.shape[0]} store rows ({count} live), two runs "
        f"equal; a NaN in an unmatched row turns its lane NaN in both; a "
        f"+Inf in a matched row gives its request +Inf "
        f"({int((lane == float('inf')).sum())} requests Inf, "
        f"{int(lane.isnan().sum())} NaN)")
    b = max(BATCHES)
    ms = cuda_ms(lambda: store_windowfold(state, vals, *q, use_kernel=True),
                 reps)
    plain_ms = cuda_ms(lambda: store_windowfold(state, vals, *q,
                                                use_kernel=False), 3)
    f = vals.shape[1]
    # least work: each live row's key, ts and F lanes read once, the
    # (B, F) sums written once; the dense count (three compares and a
    # multiply-add per (request, live row, lane)) is shown beside it
    nbytes = count * (8 + 4 * f) + b * 12 + b * f * 4
    b_ms, b_by = bound(nbytes, 0)
    dense_ms = b * count * (3 + f) / F32_OPS_PER_S * 1e3
    log(f"batch_windowfold B={b} C={vals.shape[0]} F={f} max_abs_err={err} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
        f"dense_ops_ms={dense_ms:.5f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "dense_ops_ms": dense_ms}


def bucket_inputs(actions, bucket_ms: int, n_buckets: int, dev):
    """The deployment's action rows as bucket-build input: (price,
    quantity) lanes with NULL (NaN) prices in every 100,003rd row from
    row 7, and timestamps pushed out of range (a negative bucket, one
    past the last) in every 50,000th row."""
    vals = np.stack([actions.columns["price"],
                     actions.columns["quantity"]], 1).astype(np.float32)
    vals[7::100_003, 0] = np.nan
    ts = actions.columns["ts"].astype(np.int32).copy()
    ts[::50_000] = -5
    ts[1::50_000] = n_buckets * bucket_ms + 7
    return (torch.from_numpy(vals).to(dev), torch.from_numpy(ts).to(dev))


def check_bucket_build(actions, dev, reps):
    """``bucket_build`` over the action rows at each bucket width: kernel
    against plain version (rtol 1e-4, NaN positions equal), twice
    bitwise, counts exact.  Then, at each width, ``segagg_cuda`` and one
    ``index_add_`` call timed on the same prepared inputs (the lanes with
    the count column, the bucket ids; ``index_add_`` gets them masked and
    widened as it needs), the kernel's passes by name under the profiler,
    and ``bucket_build`` whole (its ``cat``/``div`` included)."""
    from repro_torch.kernels.segagg import bucket_build
    from repro_torch.kernels.segagg.kernel import segagg_cuda
    from repro_torch.kernels.segagg.ref import segagg_ref

    res, err = {}, 0.0
    for bucket_ms, n_buckets in BUCKETS:
        vals, ts = bucket_inputs(actions, bucket_ms, n_buckets, dev)
        got = bucket_build(vals, ts, bucket_ms, n_buckets, use_kernel=True)
        again = bucket_build(vals, ts, bucket_ms, n_buckets,
                             use_kernel=True)
        torch.cuda.synchronize()
        name = f"bucket_build[{n_buckets} buckets]"
        same_bits(name, got, again)
        want = bucket_build(vals, ts, bucket_ms, n_buckets,
                            use_kernel=False)
        err = max(err, compare(name, got, want, rtol=1e-4, atol=1e-3))
        seg = torch.div(ts, bucket_ms, rounding_mode="floor")
        in_range = int(((seg >= 0) & (seg < n_buckets)).sum())
        if int(got[:, 2].sum()) != in_range or not got[:, 0].isnan().any():
            raise AssertionError(f"{name}: counts or NULL sums wrong")
        res[n_buckets] = (vals, ts, bucket_ms)
    log(f"bucket_build: kernel == plain (rtol 1e-4) at {BUCKETS} over "
        f"{len(actions)} rows, two runs equal, counts exact, NULL prices "
        f"confined to their buckets")
    out = {}
    for bucket_ms, n_buckets in BUCKETS:
        vals, ts, _ = res[n_buckets]
        aug = torch.cat([vals, torch.ones_like(vals[:, :1])], 1).contiguous()
        seg = torch.div(ts, bucket_ms, rounding_mode="floor").to(
            torch.int32).contiguous()
        ok = (seg >= 0) & (seg < n_buckets)
        ids = torch.where(ok, seg, 0).long()
        masked = torch.where(ok[:, None], aug, 0.0)
        zeros = torch.zeros((n_buckets, 3), device=dev)
        ms = cuda_ms(lambda: segagg_cuda(aug, seg, n_buckets), reps)
        lib_ms = cuda_ms(lambda: zeros.clone().index_add_(0, ids, masked),
                         reps)
        ms_again = cuda_ms(lambda: segagg_cuda(aug, seg, n_buckets), reps)
        plain_ms = cuda_ms(lambda: segagg_ref(aug, seg, n_buckets), reps)
        bb_ms = cuda_ms(lambda: bucket_build(vals, ts, bucket_ms, n_buckets,
                                             use_kernel=True), reps)
        bb_plain_ms = cuda_ms(lambda: bucket_build(
            vals, ts, bucket_ms, n_buckets, use_kernel=False), reps)
        passes = kernel_times(lambda: segagg_cuda(aug, seg, n_buckets), 5,
                              ms)
        n = vals.shape[0]
        # least work: the (N, 3) lanes and the ids read once, the (S, 3)
        # sums written once; one add per row and lane
        b_ms, b_by = bound(n * (4 * 3 + 4) + n_buckets * 3 * 4, n * 3)
        log(f"segagg N={n} S={n_buckets} F=3: segagg_cuda ms={ms:.4f} "
            f"(again {ms_again:.4f}), index_add_ library_ms={lib_ms:.4f}, "
            f"plain segagg_ref plain_ms={plain_ms:.4f}, all on the same "
            f"inputs; passes {passes}; bucket_build ms={bb_ms:.4f} (plain "
            f"{bb_plain_ms:.4f}); bound_ms={b_ms:.5f} ({b_by})")
        out[n_buckets] = {"ms": ms, "ms_again": ms_again,
                          "library_ms": lib_ms, "plain_ms": plain_ms,
                          "bucket_build_ms": bb_ms,
                          "bucket_build_plain_ms": bb_plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "passes_ms": passes}
    first = out[BUCKETS[0][1]]
    return {"max_abs_err": err, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"]}, out


def check_linear_scan(dev, reps):
    """The SSM prefill scan of hymba-1.5b, (B, T, d_inner * state) =
    (8, 1024, 51,200) float32 with a in (0, 1): kernel against plain
    version bitwise, two runs bitwise."""
    from repro_torch.kernels.chunked_scan.kernel import linear_scan_cuda
    from repro_torch.kernels.chunked_scan.ref import linear_scan_ref

    gen = torch.Generator(device=dev).manual_seed(13)
    shape = (MODEL_BATCH, MODEL_PROMPT, 51_200)
    a = torch.rand(shape, generator=gen, device=dev) * 0.7 + 0.3
    x = torch.randn(shape, generator=gen, device=dev)
    got = linear_scan_cuda(a, x)
    again = linear_scan_cuda(a, x)
    torch.cuda.synchronize()
    same_bits("linear_scan", got, again)
    want = linear_scan_ref(a, x)
    err = compare("linear_scan", got, want)
    if not torch.isfinite(got).all():
        raise AssertionError("linear_scan: non-finite output")
    del got, again, want
    ms = cuda_ms(lambda: linear_scan_cuda(a, x), reps)
    plain_ms = cuda_ms(lambda: linear_scan_ref(a, x), 2)
    n = a.numel()
    # least work: a and x read once, y written once; a multiply and an
    # add per element
    b_ms, b_by = bound(3 * n * 4, 2 * n)
    log(f"linear_scan {tuple(shape)} f32: kernel == plain (bitwise), two "
        f"runs equal; ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def decode_inputs(dev, sliding: bool, draw: int = 0):
    """One decode step of hymba-1.5b's attention at positions 1,024+: q
    (8, 25, 64) float32, a bf16 cache (8, 2,048, 5, 64), live lengths in
    DECODE_LIVE; ``sliding`` starts each live range 1,024 keys back, as
    on a sliding-window layer.  ``draw`` picks another seed (another
    cache)."""
    gen = torch.Generator(device=dev).manual_seed(17 + sliding + 2 * draw)
    b, hq, hkv, d = MODEL_BATCH, 25, 5, 64
    q = torch.randn((b, hq, d), generator=gen, device=dev)
    k, v = (torch.randn((b, MODEL_MAX_LEN, hkv, d), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    hi = torch.randint(DECODE_LIVE[0], DECODE_LIVE[1] + 1, (b,),
                       generator=gen, device=dev, dtype=torch.int32)
    lo = torch.clamp(hi - 1024, min=0) if sliding else torch.zeros_like(hi)
    return q, k, v, lo, hi


def decode_library(q, k, v, lo, hi):
    """The yardstick (never the port): one
    ``scaled_dot_product_attention`` call with a boolean live-range mask
    and ``enable_gqa``, which returns the finalized attention."""
    pos = torch.arange(k.shape[1], device=k.device)
    mask = ((pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None]))
    return torch.nn.functional.scaled_dot_product_attention(
        q.to(k.dtype)[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None, None, :], enable_gqa=True)[:, :, 0]


def rotating(fn, inputs):
    """``fn`` over the argument tuples in turn, one per call."""
    it = itertools.cycle(inputs)
    return lambda: fn(*next(it))


def check_decode_partials(dev, reps):
    """Kernel against plain version (rtol 1e-4 / atol 1e-5), two runs
    bitwise, for live ranges from 0 (global layers) and from lo > 0
    (sliding-window layers); times and bound for both, the library call
    beside them: warm (one cache, as a loop over one layer finds it in
    L2) and cold (a rotation of DECODE_COLD caches, 21 MB each, far past
    the 50 MB L2, as the model's 32 layers find theirs)."""
    from repro_torch.kernels.flash_decode.kernel import decode_partials_cuda
    from repro_torch.kernels.flash_decode.ref import (decode_partials_ref,
                                                      finalize_partials)

    res = {}
    for sliding in (False, True):
        name = "sliding" if sliding else "global"
        q, k, v, lo, hi = decode_inputs(dev, sliding)
        got = decode_partials_cuda(q, k, v, lo, hi)
        again = decode_partials_cuda(q, k, v, lo, hi)
        torch.cuda.synchronize()
        want = decode_partials_ref(q, k, v, lo, hi)
        err = 0.0
        for part, a, b, c in zip("mlo", got, again, want):
            same_bits(f"decode_partials[{name}/{part}]", a, b)
            err = max(err, compare(f"decode_partials[{name}/{part}]", a, c,
                                   rtol=1e-4, atol=1e-5))
        lib = decode_library(q, k, v, lo, hi).float()
        err_lib = float((finalize_partials(*got) - lib).abs().max())
        ms = cuda_ms(lambda: decode_partials_cuda(q, k, v, lo, hi), reps)
        plain_ms = cuda_ms(lambda: decode_partials_ref(q, k, v, lo, hi), 20)
        lib_ms = cuda_ms(lambda: decode_library(q, k, v, lo, hi), reps)
        sets = [decode_inputs(dev, sliding, i) for i in range(DECODE_COLD)]
        cold_ms = cuda_ms(rotating(decode_partials_cuda, sets), reps)
        cold_lib_ms = cuda_ms(rotating(decode_library, sets), reps)
        del sets
        passes = kernel_times(lambda: decode_partials_cuda(q, k, v, lo, hi),
                              5, ms)
        live = int((hi - lo).sum())
        b, hq, d = q.shape
        hkv = k.shape[2]
        # least work: each live K and V row read once (bf16), q read and
        # the partials written once; 4 * d flops per live key and head
        nbytes = live * hkv * d * 2 * 2 + b * hq * d * 4 + b * hq * (d + 2) * 4
        b_ms, b_by = bound(nbytes, live * (hq // hkv) * hkv * 4 * d)
        log(f"decode_partials[{name}] B={b} Hq={hq} Hkv={hkv} D={d} bf16 "
            f"cache S={k.shape[1]}, {live} live keys: kernel == plain "
            f"(rtol 1e-4), two runs equal, max_abs_err={err}; finalized vs "
            f"SDPA (bf16) max diff {err_lib:.3e}; ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by}); cold in L2 over {DECODE_COLD} "
            f"caches: ms={cold_ms:.4f} library_ms={cold_lib_ms:.4f}; "
            f"passes {passes}")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "cold_ms": cold_ms, "cold_library_ms": cold_lib_ms,
                     "passes_ms": passes, "live_keys": live}
    return res


# ---------------------------------------------------------------- phase 4d


def model_prompt(cfg):
    gen = torch.Generator().manual_seed(5)
    return torch.randint(0, cfg.vocab_size, (MODEL_BATCH, MODEL_PROMPT),
                         generator=gen, dtype=torch.int32).numpy()


def teacher_forced(engine, prompt, tokens):
    """Prefill, then decode the given tokens; every step's logits."""
    out = [engine.prefill({"tokens": prompt})]
    for i in range(tokens.shape[1]):
        out.append(engine.decode(tokens[:, i:i + 1]))
    return out


def check_logits(logits, cfg):
    for i, x in enumerate(logits):
        if x.shape != (MODEL_BATCH, cfg.vocab_padded) or \
                not np.isfinite(x).all():
            raise AssertionError(f"model logits {i}: shape {x.shape} or "
                                 f"non-finite values")


def model_serving(dev, card):
    """Phase 4d: hymba-1.5b at full width and depth on the card."""
    from repro_torch.configs import get
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServingEngine

    cfg = get(MODEL_ARCH)
    prompt = model_prompt(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{MODEL_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} G params drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; B={MODEL_BATCH} prompts of "
        f"{MODEL_PROMPT} tokens, max_len {MODEL_MAX_LEN}, "
        f"{MODEL_TOKENS} greedy tokens")

    # f32: the main path through the kernels, then kernels vs plain
    kern = ServingEngine(cfg, params, max_len=MODEL_MAX_LEN,
                         dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    tokens, counts_f32 = run_path(
        "model serving (f32)",
        lambda: kern.generate_greedy({"tokens": prompt}, MODEL_TOKENS),
        ("linear_scan", "decode_partials"))
    t_f32 = time.perf_counter() - t0
    expect = {"linear_scan": cfg.n_layers,
              "decode_partials": cfg.n_layers * MODEL_TOKENS}
    for k, n in expect.items():
        if counts_f32.get(k) != n:
            raise AssertionError(f"model serving: {counts_f32.get(k)} {k} "
                                 f"launches, expected {n}")
    if tokens.shape != (MODEL_BATCH, MODEL_TOKENS) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_padded:
        raise AssertionError(f"generate_greedy: bad tokens {tokens.shape}")
    got = teacher_forced(kern, prompt, tokens)
    del kern
    plain = ServingEngine(cfg, params, max_len=MODEL_MAX_LEN,
                          dtype=torch.float32, device=dev, use_kernel=False)
    want = teacher_forced(plain, prompt, tokens)
    del plain
    check_logits(got, cfg)
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not np.allclose(a, b, rtol=MODEL_TOL, atol=MODEL_TOL):
            raise AssertionError(f"model logits step {i}: kernels != plain "
                                 f"(max diff {np.abs(a - b).max()})")
        err = max(err, float(np.abs(a - b).max()))
    if not np.array_equal(np.stack([x.argmax(-1) for x in got[:-1]], 1),
                          tokens):
        raise AssertionError("teacher-forced kernel run: argmax differs "
                             "from generate_greedy's tokens")
    log(f"f32 generate_greedy {t_f32:.1f} s; teacher-forced prefill + "
        f"{MODEL_TOKENS} steps: kernels == plain versions within "
        f"{MODEL_TOL} (max abs diff {err:.3e}, logits ~"
        f"{float(np.abs(want[0]).max()):.2f}); argmax reproduces the "
        f"generated tokens")

    # bf16: the reference's serving dtype, timed
    params = _cast(params)
    torch.cuda.empty_cache()
    eng = ServingEngine(cfg, params, max_len=MODEL_MAX_LEN,
                        dtype=torch.bfloat16, device=dev)
    eng.generate_greedy({"tokens": prompt}, 2)             # warm-up
    t0 = time.perf_counter()
    tok_bf16, counts_bf16 = run_path(
        "model serving (bf16)",
        lambda: eng.generate_greedy({"tokens": prompt}, MODEL_TOKENS),
        ("linear_scan", "decode_partials"))
    t_gen = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = eng.prefill({"tokens": prompt})
    prefill_ms = (time.perf_counter() - t0) * 1e3
    steps = []
    for i in range(MODEL_TOKENS):
        t0 = time.perf_counter()
        last = eng.decode(tok_bf16[:, i:i + 1])
        steps.append((time.perf_counter() - t0) * 1e3)
    check_logits([first, last], cfg)
    tok_s = MODEL_BATCH * MODEL_TOKENS / (sum(steps) / 1e3)
    prof_dec = profile_calls(lambda: eng.decode(tok_bf16[:, :1]), 8)
    prof_pre = profile_calls(lambda: eng.prefill({"tokens": prompt}), 1)
    out = {"params_g": n_params / 1e9, "f32_generate_s": t_f32,
           "f32_max_abs_diff": err, "bf16_generate_s": t_gen,
           "bf16_prefill_ms": prefill_ms,
           "bf16_decode_ms_p50": float(np.percentile(steps, 50)),
           "bf16_decode_ms_p99": float(np.percentile(steps, 99)),
           "bf16_decode_ms": steps, "bf16_decode_tokens_per_s": tok_s,
           "launches_f32": counts_f32, "launches_bf16": counts_bf16,
           "profile_decode": prof_dec, "profile_prefill": prof_pre,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"bf16 prefill {prefill_ms:.1f} ms (B={MODEL_BATCH} x "
        f"{MODEL_PROMPT} tokens); decode per token p50 "
        f"{out['bf16_decode_ms_p50']:.2f} ms, p99 "
        f"{out['bf16_decode_ms_p99']:.2f} ms over {MODEL_TOKENS} steps; "
        f"{tok_s:.0f} tokens/s; generate_greedy {t_gen:.2f} s  [{card}]")
    log_profile("decode step (bf16)", prof_dec, card)
    attn = {k: v for k, v in prof_dec["kernel_ms_per_call"].items()
            if "decode_split_kernel" in k or "decode_merge_kernel" in k}
    out["decode_partials_ms_per_step"] = sum(attn.values())
    log(f"decode_partials in a decode step: {sum(attn.values()):.4f} ms of "
        f"{prof_dec['device_ms_per_call']:.3f} ms device time ({attn})  "
        f"[{card}]")
    log_profile("prefill (bf16)", prof_pre, card)
    del eng, params
    torch.cuda.empty_cache()
    return out, {"model_f32": counts_f32, "model_bf16": counts_bf16}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _cast(tree):
    if isinstance(tree, dict):
        return {k: _cast(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v) for v in tree]
    return tree.to(torch.bfloat16)


def profile_calls(fn, n: int):
    """Device time and kernel count of ``n`` calls of ``fn`` from the
    profiler's kernel events, beside the host wall time they took."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
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
    return {"wall_ms_per_call": wall_ms / n,
            "device_ms_per_call": dev_ms / n,
            "kernel_ms_per_call": {k: v / 1e3 / n
                                   for k, v in by_name.items()},
            "kernels_per_call": len(kernels) / n,
            "device_busy_share": dev_ms / wall_ms if wall_ms else 0.0,
            "top_kernels_ms_per_call": [(k[:60], v / 1e3 / n)
                                        for k, v in top],
            "top_host_ops_ms_per_call": [(k[:60], v / 1e3 / n, c / n)
                                         for k, v, c in host]}


def kernel_times(fn, n: int, ms: float):
    """{kernel name: device ms per call} of ``fn`` under the profiler,
    held to ``ms``, the call's time from CUDA events: the profiler has
    been seen to keep the kernels of only some of the calls it traced, so
    a trace whose kernels do not add up to within 25% of ``ms`` is taken
    again, and after three such traces the passes are not measured (an
    empty dict)."""
    for _ in range(3):
        prof = profile_calls(fn, n)
        if abs(prof["device_ms_per_call"] - ms) <= 0.25 * ms:
            return dict(prof["top_kernels_ms_per_call"])
    return {}


def log_profile(label: str, prof, card: str) -> None:
    if prof["kernels_per_call"] == 0:
        log(f"profile {label}: no device events (device time not "
            f"measured)")
        return
    log(f"profile {label}: wall {prof['wall_ms_per_call']:.3f} ms, device "
        f"{prof['device_ms_per_call']:.3f} ms "
        f"({prof['kernels_per_call']:.0f} kernels), device busy share "
        f"{prof['device_busy_share']:.3f}  [{card}]")
    for name, ms in prof["top_kernels_ms_per_call"]:
        log(f"  device {ms:.4f} ms  {name}")
    for name, ms, calls in prof["top_host_ops_ms_per_call"]:
        log(f"  host self {ms:.4f} ms  {calls:.0f} calls  {name}")


# ---------------------------------------------------------------- phase 4


def run_path(name: str, fn, expect):
    """Drive one main path with the launch counts set to 0 just before
    it and read just after; every kernel in ``expect`` must have
    launched.  Returns (fn's result, counts)."""
    from repro_torch.kernels import dispatch

    dispatch.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    log(f"launches during the {name} path: {counts}")
    for k in expect:
        if counts.get(k, 0) < 1:
            raise AssertionError(f"{name} path did not launch {k}")
    return out, counts


def slice_table(table, lo: int, hi: int):
    from repro_torch.core.types import Table

    return Table(table.schema, {c: v[lo:hi] for c, v in
                                table.columns.items()}, dicts=table.dicts)


def stride_table(table, k: int):
    """Every ``k``-th row of a table (the whole horizon, thinned)."""
    from repro_torch.core.types import Table

    return Table(table.schema, {c: v[::k] for c, v in
                                table.columns.items()}, dicts=table.dicts)


def compare_features(gpu, cpu, loose=("ew",)) -> float:
    """Per-request features, finite and of one shape: bitwise, except
    the ``loose`` columns at rtol ``EW_RTOL``."""
    if len(gpu) != len(cpu):
        raise AssertionError(f"{len(gpu)} feature rows != {len(cpu)}")
    err = 0.0
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        if set(a) != set(b):
            raise AssertionError(f"features {sorted(a)} != {sorted(b)}")
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            if not np.all(np.isfinite(x)):
                raise AssertionError(f"feature {k}[{i}] not finite: {x}")
            if x.shape != y.shape:
                raise AssertionError(f"feature {k}[{i}] shape {x.shape} "
                                     f"!= {y.shape}")
            if k in loose:
                ok = np.allclose(x, y, rtol=EW_RTOL, atol=1e-6)
            else:
                ok = np.array_equal(x, y)
            if not ok:
                raise AssertionError(f"feature {k}[{i}]: {x} != {y}")
            err = max(err, float(np.max(np.abs(x.astype(np.float64) - y))))
    return err


def compare_offline(name: str, got, want, n_rows: int) -> float:
    """Offline features on the card against the plain-fold run: finite
    (the deployment has no NULL), of the base table's length, bitwise
    except ``ew`` (rtol 1e-5)."""
    if list(got) != list(want):
        raise AssertionError(f"{name}: features {list(got)} != "
                             f"{list(want)}")
    err = 0.0
    for k in want:
        x, y = got[k], want[k]
        if x.shape[0] != n_rows or not np.all(np.isfinite(x)):
            raise AssertionError(f"{name}: feature {k} has shape "
                                 f"{x.shape} or non-finite values")
        ok = (np.allclose(x, y, rtol=EW_RTOL, atol=1e-6) if k == "ew"
              else np.array_equal(x, y))
        if not ok:
            raise AssertionError(f"{name}: feature {k} != plain fold")
        err = max(err, float(np.max(np.abs(x.astype(np.float64) - y))))
    return err


def compare_tolerance(name: str, got, want, exact) -> float:
    """Whole-table features: the ``exact`` columns bitwise, the rest at
    ``SEED_TOL`` as the reference's consistency gate reads it (a column
    passes when its max abs diff is within atol or its max diff relative
    to max(|want|, 1) within rtol); returns the max abs diff."""
    if set(got) != set(want):
        raise AssertionError(f"{name}: features {sorted(got)} != "
                             f"{sorted(want)}")
    err = 0.0
    for k in want:
        x = np.asarray(got[k], np.float64)
        y = np.asarray(want[k], np.float64)
        if x.shape != y.shape or not np.all(np.isfinite(x)):
            raise AssertionError(f"{name}: feature {k} has shape {x.shape} "
                                 f"or non-finite values")
        d = np.abs(x - y)
        dmax = float(d.max()) if d.size else 0.0
        rel = float((d / np.maximum(np.abs(y), 1.0)).max()) if d.size \
            else 0.0
        ok = (dmax == 0.0 if k in exact
              else dmax <= SEED_TOL["atol"] or rel <= SEED_TOL["rtol"])
        if not ok:
            raise AssertionError(f"{name}: feature {k} differs (max abs "
                                 f"{dmax}, rel {rel})")
        err = max(err, dmax)
    return err


def key_abs_totals(tables, col: str = "price") -> np.ndarray:
    """Per key, the sum of |col| over its rows in every table: the
    magnitude a prefix over the key's history reaches."""
    keys = [t.columns["userid"] for t in tables.values()]
    tot = np.zeros(int(max(k.max() for k in keys)) + 1)
    for t, k in zip(tables.values(), keys):
        np.add.at(tot, k, np.abs(t.columns[col].astype(np.float64)))
    return tot


def key_history_abs(tables, col: str = "price") -> np.ndarray:
    """Per base row, the sum of |col| over its key's rows in every
    table: the magnitude the seed baseline's prefixes reach."""
    return key_abs_totals(tables, col)[tables["actions"].columns["userid"]]


def compare_seed(got, want, tables) -> float:
    """The seed baseline against ``offline()``: the additive columns
    within the prefix bound, every other column as
    ``compare_tolerance`` (count, distinct count, min, max and the hash
    bitwise)."""
    bar = SEED_TOL["atol"] + SEED_PREFIX_ULPS * 2.0**-24 * key_history_abs(
        tables)
    err = 0.0
    for k in SEED_ADDITIVE:
        d = np.abs(np.asarray(got[k], np.float64) - want[k])
        if not np.all(d <= bar):
            raise AssertionError(f"seed baseline: {k} beyond the prefix "
                                 f"bound (max abs {float(d.max())})")
        err = max(err, float(d.max()))
    rest = [k for k in want if k not in SEED_ADDITIVE]
    return max(err, compare_tolerance(
        "seed baseline", {k: got[k] for k in rest},
        {k: want[k] for k in rest},
        exact=("c", "dc", "mn", "mx", "cat_h")))


def store_arrays(eng):
    """An engine's store as numpy arrays (``load_store_from``'s input)."""
    return {t: {"keys": st["keys"].cpu().numpy(),
                "ts": st["ts"].cpu().numpy(),
                "count": st["count"].cpu().numpy(),
                "cols": {c: v.cpu().numpy() for c, v in st["cols"].items()}}
            for t, st in eng.store.tables.items()}


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def same_tree(name: str, a, b) -> None:
    for x, y in zip(_leaves(a), _leaves(b)):
        same_bits(name, x, y)


def latencies(fn, rows, reps: int):
    """Host-inclusive p50/p99 of ``fn(rows[:b])`` per B (CUDA events;
    every call ends by copying features to the host)."""
    out = {}
    for b in BATCHES:
        for _ in range(3):
            fn(rows[:b])
        samples = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(rows[:b])
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        out[b] = {"p50_ms": float(np.percentile(samples, 50)),
                  "p99_ms": float(np.percentile(samples, 99))}
    return out


def log_latency(label: str, lat, reps: int, card: str) -> None:
    for b, r in lat.items():
        log(f"{label} B={b}: p50 {r['p50_ms']:.3f} ms, p99 "
            f"{r['p99_ms']:.3f} ms over {reps} batches  [{card}]")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------- phase 4e


def staged_path(tables, eng, reqs, served, off, card):
    """The staged fold (``fused_fold=False``) on a copy of 4a's store:
    ``request_batch`` and ``request`` against 4a's fused features,
    ``offline()`` against 4b's, and the seed baseline
    (``run_reference_serial``) at the reduction-order bar."""
    from repro_torch.core import multiwindow
    from repro_torch.serve.engine import FeatureEngine

    n_act = len(tables["actions"])
    staged = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                           fused_fold=False, device="cuda")
    staged.load_store_from(store_arrays(eng))

    def serve():
        return ({b: staged.request_batch(reqs[:b]) for b in BATCHES},
                staged.request(reqs[0]))

    (got, one), counts = run_path("staged serving", serve,
                                  ("feature_hash",))
    paths = {"staged_serving": counts}
    err = max(compare_features(got[b], served[b]) for b in BATCHES)
    compare_features([one], got[1], loose=())
    t0 = time.perf_counter()
    st_off, counts = run_path("staged offline", staged.offline,
                              ("feature_hash",))
    t_off_first = time.perf_counter() - t0
    paths["staged_offline"] = counts
    err_off = compare_offline("staged offline", st_off, off, n_act)
    _, t_off = timed(staged.offline)
    t0 = time.perf_counter()
    seed, counts = run_path(
        "seed baseline",
        lambda: multiwindow.run_reference_serial(staged.cs, tables,
                                                 device="cuda"),
        ("feature_hash",))
    t_seed = time.perf_counter() - t0
    paths["seed_baseline"] = counts
    err_seed = compare_seed(seed, st_off, tables)
    # the same baseline in plain torch on the host CPU: the same bits
    # (ew within rtol 1e-5)
    t0 = time.perf_counter()
    compare_offline("seed baseline on the CPU", seed,
                    multiwindow.run_reference_serial(staged.cs, tables,
                                                     device="cpu"), n_act)
    t_seed_cpu = time.perf_counter() - t0
    for name, c in paths.items():
        if c.get("unit_fold", 0):
            raise AssertionError(f"{name} launched the unit-fold kernel")
    log(f"staged request_batch B={BATCHES} equal 4a's fused features "
        f"(bitwise; ew within rtol {EW_RTOL}, max abs diff {err}); "
        f"request(row 0) equals B=1 bitwise; staged offline equals 4b's "
        f"(max abs diff {err_off}); seed baseline equals it (c, dc, mn, "
        f"mx, cat_h bitwise; s, a within {SEED_PREFIX_ULPS} float32 ulps "
        f"of the key history's |price| sum; the rest at rtol "
        f"{SEED_TOL['rtol']} / atol {SEED_TOL['atol']}; max abs diff "
        f"{err_seed}) and its own CPU run (bitwise, ew within rtol "
        f"{EW_RTOL}; {t_seed_cpu:.1f} s on the host)")
    lat = latencies(staged.request_batch, reqs, STAGED_REPS)
    log_latency("staged request_batch", lat, STAGED_REPS, card)
    prof = profile_calls(lambda: staged.request_batch(reqs[:256]), 3)
    log_profile("staged request_batch B=256", prof, card)
    log(f"staged offline over {n_act + len(tables['orders'])} rows: first "
        f"call {t_off_first:.2f} s (plan + upload + fold), plan cached "
        f"{t_off * 1e3:.1f} ms; seed baseline {t_seed * 1e3:.1f} ms  "
        f"[{card}]")
    return {"latency": lat, "profile_b256": prof,
            "offline_first_s": t_off_first, "offline_cached_ms": t_off * 1e3,
            "seed_baseline_ms": t_seed * 1e3}, paths


# ---------------------------------------------------------------- phase 4f


def long_windows(card):
    """``use_preagg`` serving of LONG_SQL at deployment size: planes
    maintained by bulk load and ingest, requests against a CPU engine on
    copies of the store and planes and against ``offline()``, and
    ``verify_consistency(use_preagg=True)`` over every 300th row."""
    from repro_torch.core import (compile_script, replay_online,
                                  verify_consistency)
    from repro_torch.data.synthetic import make_action_tables
    from repro_torch.serve.engine import FeatureEngine

    tables = make_action_tables(**DEPLOYMENT_LONG)
    actions, orders = tables["actions"], tables["orders"]
    n_act = len(actions)
    hist_end = n_act - N_LIVE - max(BATCHES)
    eng = FeatureEngine(LONG_SQL, tables, capacity=CAPACITY,
                        use_preagg=True, fused_fold=True, device="cuda")
    cs = eng.cs
    wi, pa = next((i, w.preagg) for i, w in enumerate(cs.windows)
                  if w.preagg is not None)
    shape = (pa.n_keys, pa.n_fine, pa.n_coarse, pa.max_coarse_q,
             pa.max_bucket_rows)
    if shape != LONG_PLANES:
        raise AssertionError(f"pre-agg planes {shape} != {LONG_PLANES}")
    hist = slice_table(actions, 0, hist_end)
    _, t_load = timed(lambda: (eng.bulk_load("actions", hist),
                               eng.bulk_load("orders", orders)))

    def update(pre, name, t):
        # the engine's own inputs: every stored column as float32
        return cs.preagg_update_many(
            pre, name, t.columns["userid"], t.columns["ts"],
            {c: t.columns[c].astype(np.float32) for c in eng._need[name]})

    def fold_loaded():
        pre = cs.init_preagg_states("cuda")
        for name, t in (("actions", hist), ("orders", orders)):
            pre = update(pre, name, t)
        return pre

    planes, t_planes_load = timed(fold_loaded)
    same_tree("planes after bulk_load", planes, eng.pre_states)
    prof_update = profile_calls(lambda: update(
        cs.init_preagg_states("cuda"), "actions", hist), 1)
    del planes
    before = tree_to(eng.pre_states, "cuda")
    live = [actions.row(i) for i in range(hist_end, hist_end + N_LIVE)]
    _, t_ingest = timed(lambda: eng.ingest_many("actions", live))
    live_t = slice_table(actions, hist_end, hist_end + N_LIVE)
    again, t_planes_ingest = timed(lambda: update(before, "actions",
                                                  live_t))
    same_tree("planes after ingest_many", again, eng.pre_states)
    del before, again
    plane_bytes = pa.plane_bytes(eng.pre_states[wi])
    log(f"pre-agg planes {LONG_PLANES[:3]} (keys, fine, coarse slots), "
        f"{plane_bytes} bytes; bulk_load {hist_end + len(orders)} rows "
        f"{t_load:.2f} s, of which planes {t_planes_load:.2f} s; "
        f"update_many over the loaded actions: {prof_update['kernels_per_call']:.0f} "
        f"launches, wall {prof_update['wall_ms_per_call']:.0f} ms; "
        f"ingest_many {N_LIVE} rows {t_ingest:.3f} s, of which planes "
        f"{t_planes_ingest:.3f} s  [{card}]")

    base = hist_end + N_LIVE
    reqs = [dict(actions.row(i)) for i in range(base, base + max(BATCHES))]
    served, counts = run_path(
        "long windows", lambda: {b: eng.request_batch(reqs[:b])
                                 for b in BATCHES},
        ("unit_fold", "feature_hash"))
    paths = {"long_windows": counts}
    cpu = FeatureEngine(LONG_SQL, tables, capacity=CAPACITY,
                        use_preagg=True, fused_fold=True, device="cpu")
    cpu.load_store_from(store_arrays(eng))
    cpu.pre_states = tree_to(eng.pre_states, "cpu")
    err = compare_features(served[64], cpu.request_batch(reqs[:64]),
                           loose=LONG_LOOSE)
    del cpu
    # the first request row sees exactly the history offline() sees for
    # it: the stored actions and every order
    off = cs.offline({"actions": slice_table(actions, 0, base + 1),
                      "orders": orders}, device="cuda")
    err_off = compare_tolerance(
        "first request vs offline",
        {k: np.asarray(v)[None] for k, v in served[1][0].items()},
        {k: v[-1:] for k, v in off.items()}, exact=LONG_EXACT_OFFLINE)
    log(f"long-window B=64 card equal to the CPU engine (bitwise; "
        f"{LONG_LOOSE} within rtol {EW_RTOL}; max abs diff {err}); first "
        f"request equal to offline() ({LONG_EXACT_OFFLINE} bitwise, the "
        f"rest within rtol {SEED_TOL['rtol']} / atol {SEED_TOL['atol']}; "
        f"max abs diff {err_off})")
    lat = latencies(eng.request_batch, reqs, STAGED_REPS)
    log_latency("long-window request_batch", lat, STAGED_REPS, card)
    prof = profile_calls(lambda: eng.request_batch(reqs[:256]), 3)
    log_profile("long-window request_batch B=256", prof, card)
    for b in (1, 64):
        p = profile_calls(lambda: eng.request_batch(reqs[:b]), 3)
        log(f"long-window request_batch B={b}: "
            f"{p['kernels_per_call']:.0f} launches per batch, device busy "
            f"share {p['device_busy_share']:.3f}  [{card}]")
    del eng

    thin = {name: stride_table(t, GATE_STRIDE) for name, t in tables.items()}
    n_thin = sum(len(t) for t in thin.values())
    gate_cs = compile_script(LONG_SQL, tables=thin)
    t0 = time.perf_counter()
    online, counts = run_path(
        "pre-agg gate", lambda: replay_online(gate_cs, thin, use_preagg=True,
                                              device="cuda"),
        ("unit_fold", "feature_hash"))
    rep = verify_consistency(gate_cs, thin, use_preagg=True, bitwise=False,
                             online_outputs=online, device="cuda")
    t_gate = time.perf_counter() - t0
    paths["preagg_gate"] = counts
    gate_off = gate_cs.offline(thin, device="cuda")
    for k in GATE_BITWISE:
        if not np.array_equal(online[k], gate_off[k]):
            raise AssertionError(f"pre-agg gate: {k} not bitwise")
    if not rep.passed:
        raise AssertionError(f"verify_consistency(use_preagg=True): {rep}")
    log(f"verify_consistency(use_preagg=True) on the card over {n_thin} "
        f"rows (every {GATE_STRIDE}th): {rep}; {GATE_BITWISE} bitwise; "
        f"{t_gate:.1f} s  [{card}]")
    return {"plane_bytes": plane_bytes, "latency": lat,
            "profile_b256": prof, "bulk_load_s": t_load,
            "planes_load_s": t_planes_load, "update_many": prof_update,
            "ingest_s": t_ingest, "planes_ingest_s": t_planes_ingest,
            "gate_rows": n_thin, "gate_s": t_gate}, paths


# ---------------------------------------------------------------- phase 4g


def merged_stream(tables, lo_ts: int):
    """Rows of both tables with ts >= ``lo_ts`` as (table, row) in the
    offline order: ts, then orders before actions, then arrival."""
    ev = []
    for name, t in tables.items():
        ts = t.columns["ts"]
        start = int(np.searchsorted(ts, lo_ts, side="left"))
        ev += [(int(ts[i]), name != "orders", i, name)
               for i in range(start, len(t))]
    ev.sort()
    return [(name, tables[name].row(i)) for _, _, i, name in ev]


def table_runs(stream, max_rows: int = 1 << 30):
    """Consecutive rows of one table as ingest batches (table, rows)."""
    out = []
    for name, row in stream:
        if not out or out[-1][0] != name or len(out[-1][1]) >= max_rows:
            out.append((name, []))
        out[-1][1].append(row)
    return out


def same_features(name: str, a, b) -> None:
    """Byte-identical per-request features."""
    if len(a) != len(b):
        raise AssertionError(f"{name}: {len(a)} rows != {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if set(x) != set(y):
            raise AssertionError(f"{name}: features differ")
        for k in x:
            if np.asarray(x[k]).tobytes() != np.asarray(y[k]).tobytes():
                raise AssertionError(f"{name}: {k}[{i}] {x[k]} != {y[k]}")


def compare_retained(got, want, bar) -> float:
    """A retention engine against one without: counts, distinct counts,
    min, max, drawdown and the hash bitwise, ``ew`` within ``EW_RTOL``,
    the sums within ``bar`` (eviction moves the prefix anchor)."""
    err = 0.0
    for i, (x, y) in enumerate(zip(got, want)):
        for k in y:
            a = np.asarray(x[k], np.float64)
            b = np.asarray(y[k], np.float64)
            d = float(np.max(np.abs(a - b)))
            if k in SEED_ADDITIVE:
                ok = d <= bar[i]
            elif k == "ew":
                ok = np.allclose(a, b, rtol=EW_RTOL, atol=1e-6)
            else:
                ok = np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
            if not ok:
                raise AssertionError(f"retention vs none: {k}[{i}] {x[k]} "
                                     f"!= {y[k]}")
            err = max(err, d)
    return err


def open_loop(loop, arrivals, rows) -> None:
    """Open-loop load: arrivals fire on schedule whether or not earlier
    requests completed; the loop steps whenever a flush is due (the
    arrival loop of ``benchmarks/bench_serve_loop.py``)."""
    clock = loop.clock
    t0 = clock.now()
    i = 0
    while i < len(arrivals) or loop.batcher.queue:
        now = clock.now()
        if i < len(arrivals) and now - t0 >= arrivals[i]:
            loop.submit(rows[i % len(rows)], now=now)
            i += 1
            continue
        if loop.batcher.ready(now):
            loop.step(now=now)
            continue
        if i >= len(arrivals):
            loop.run_until_idle()
            break
        time.sleep(50e-6)
    loop.flush()


def warm_loop(loop, rows) -> None:
    """Plan every pad class the loop can hit on its snapshot, then drop
    the samples."""
    b = 1
    while b <= loop.batch_size:
        loop.engine.request_batch(rows[:b], snapshot=loop.snap)
        b *= 2
    loop.reset_stats()


def loop_pcts(loop):
    p = loop.latency_percentiles()
    return {k: p[k] for k in ("TP50", "TP99", "TP999", "max_ms")}


def int_priced(tables):
    """Copies of ``tables`` with integer-valued float32 prices (every
    sum exact, whatever rows a compaction removed)."""
    from repro_torch.core.types import Table

    return {name: Table(t.schema, {
        c: (np.floor(v).astype(np.float32) if c == "price" else v.copy())
        for c, v in t.columns.items()}, dicts=t.dicts)
        for name, t in tables.items()}


def serving_loop(tables, card):
    """``ServeLoop`` over a retention engine at deployment size: (a)
    snapshot isolation across a compaction, (b) latency under the loop,
    (c) a CPU-recorded trace replayed on the card, (d) the consistency
    gate through the loop."""
    from repro_torch.core import verify_consistency
    from repro_torch.kernels import dispatch
    from repro_torch.serve import (ServeLoop, SystemClock, TraceRecorder,
                                   VirtualClock, load_trace,
                                   record_consistency_trace, replay,
                                   save_trace)
    from repro_torch.serve.engine import FeatureEngine
    from repro_torch.serve.trace import (outputs_in_base_order,
                                         store_state_arrays)

    actions, orders = tables["actions"], tables["orders"]
    ts_a, ts_o = actions.columns["ts"], orders.columns["ts"]
    cut_ts = int(ts_a[len(actions) - LOOP_STREAM])
    cut_a = int(np.searchsorted(ts_a, cut_ts, side="left"))
    cut_o = int(np.searchsorted(ts_o, cut_ts, side="left"))
    stream = merged_stream(tables, cut_ts)
    kw = dict(fused_fold=True, retention="auto",
              compact_every=COMPACT_EVERY)
    eng = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY, device="cuda",
                        **kw)
    if eng.retention_ms != RETAINED:
        raise AssertionError(f"retention {eng.retention_ms} != {RETAINED}")
    _, t_load = timed(lambda: (
        eng.bulk_load("actions", slice_table(actions, 0, cut_a)),
        eng.bulk_load("orders", slice_table(orders, 0, cut_o))))
    plain = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                          fused_fold=True, device="cuda")
    plain.load_store_from(store_arrays(eng))
    compactions = []
    store_evict = eng.store.evict

    def timed_evict(table, horizon):
        before = eng.store.n_rows(table)
        _, dt = timed(lambda: store_evict(table, horizon))
        compactions.append({"table": table, "before": before,
                            "after": eng.store.n_rows(table), "s": dt})

    eng.store.evict = timed_evict
    log(f"4g cut at ts {cut_ts}: bulk_load {cut_a} actions + {cut_o} "
        f"orders in {t_load:.1f} s; {len(stream)} rows stream after it; "
        f"retention {eng.retention_ms}, compact_every {COMPACT_EVERY}")

    # (a) snapshot isolation across a compaction
    ahead = [dict(r) for name, r in stream[SNAP_ROWS:SNAP_ROWS + 512]
             if name == "actions"]
    probe = ahead[:LOOP_BATCH]
    snap = eng.snapshot()

    def isolation():
        first = eng.request_batch(probe, snapshot=snap)
        for name, rows in table_runs(stream[:SNAP_ROWS]):
            eng.ingest_many(name, rows)
            plain.ingest_many(name, rows)
        again = eng.request_batch(probe, snapshot=snap)
        snap.refresh()
        return first, again, eng.request_batch(probe, snapshot=snap)

    (first, again, fresh), counts = run_path(
        "serving loop: snapshot", isolation, ("unit_fold", "feature_hash"))
    paths = {"loop_snapshot": counts}
    same_features("old snapshot across the compaction", first, again)
    if not compactions or compactions[0]["table"] != "orders":
        raise AssertionError(f"no orders compaction in (a): {compactions}")
    cpu = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                        fused_fold=True, device="cpu")
    cpu.load_store_from(store_arrays(eng))
    err_cpu = compare_features(fresh, cpu.request_batch(probe))
    del cpu
    key_abs = key_abs_totals(tables)[[int(r["userid"]) for r in probe]]
    bar = SEED_TOL["atol"] + SEED_PREFIX_ULPS * 2.0**-24 * key_abs
    err_plain = compare_retained(fresh, plain.request_batch(probe), bar)
    del plain
    c0 = compactions[0]
    log(f"(a) snapshot served B={LOOP_BATCH} byte-identical before and "
        f"after ingest_many of {SNAP_ROWS} streamed rows; first orders "
        f"compaction {c0['before']} -> {c0['after']} resident rows in "
        f"{c0['s'] * 1e3:.2f} ms ({len(compactions)} compactions, "
        f"{sum(x['table'] == 'orders' for x in compactions)} of orders); "
        f"refreshed: equal to a CPU engine on copies of the store "
        f"(bitwise, ew within rtol {EW_RTOL}; max abs diff {err_cpu}); "
        f"against a card engine without retention: c, dc, mn, mx, dd, "
        f"cat_h bitwise, s and a within {SEED_PREFIX_ULPS} ulps of the "
        f"key history (max abs diff {err_plain})  [{card}]")

    # (b) latency under the loop, SystemClock
    b1 = []
    for _ in range(60):
        t0 = time.perf_counter()
        eng.request_batch(probe[:1], snapshot=snap)
        b1.append((time.perf_counter() - t0) * 1e3)
    p50_b1 = float(np.percentile(b1[10:], 50))
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(2 * p50_b1 * 1e-3,
                                         size=LOOP_SPARSE))

    def latency():
        out = {"b1_p50_ms": p50_b1, "gap_ms": 2 * p50_b1}
        for mode, wait in (("deadline", LOOP_WAIT_MS), ("count_only", None)):
            loop = ServeLoop(eng, clock=SystemClock(), batch_size=LOOP_BATCH,
                             max_wait_ms=wait, slo_ms=LOOP_SLO_MS)
            warm_loop(loop, ahead)
            open_loop(loop, arrivals, ahead)
            out[mode] = dict(loop_pcts(loop), **{
                k: loop.stats[k] for k in ("served", "deadline_flushes",
                                           "size_flushes", "forced_flushes",
                                           "deadline_misses")})
        loop = ServeLoop(eng, clock=SystemClock(), batch_size=LOOP_BATCH,
                         max_wait_ms=LOOP_WAIT_MS, slo_ms=LOOP_SLO_MS)
        warm_loop(loop, ahead)
        pos = SNAP_ROWS
        for _ in range(LOOP_WAVES):
            wave = [dict(r) for name, r in stream[pos:pos + 256]
                    if name == "actions"][:LOOP_BATCH]
            for r in wave:
                loop.submit(r)
            loop.step()
            for name, rows in table_runs(stream[pos:pos + LOOP_BATCH]):
                loop.ingest(name, rows)
            loop.drain_ingest()
            pos += LOOP_BATCH
        loop.run_until_idle()
        out["mixed"] = dict(loop_pcts(loop), **{
            k: loop.stats[k] for k in ("served", "snapshot_swaps",
                                       "ingest_applies", "deadline_misses",
                                       "backpressure_applies")})
        out["mixed"]["ingest"] = eng.ingest_stats()
        out["resident_orders"] = eng.store.n_rows("orders")
        out["resident_actions"] = eng.store.n_rows("actions")
        out["binlog"] = len(eng.store.binlog)
        before = dispatch.launch_counts()
        for r in probe:
            loop.submit(r)
        loop.step()
        after = dispatch.launch_counts()
        out["flush_launches"] = {k: after[k] - before.get(k, 0)
                                 for k in after}
        out["profile_flush"] = profile_calls(
            lambda: ([loop.submit(r) for r in probe], loop.step()), 5)
        # the loop's own cost: a flush through it (64 submits + step)
        # against request_batch on the same snapshot, in turns
        via_loop, direct = [], []
        for _ in range(50):
            t0 = time.perf_counter()
            for r in probe:
                loop.submit(r)
            loop.step()
            via_loop.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            eng.request_batch(probe, snapshot=loop.snap)
            direct.append((time.perf_counter() - t0) * 1e3)
        out["flush_loop_ms"] = float(np.median(via_loop))
        out["flush_direct_ms"] = float(np.median(direct))
        t0 = time.perf_counter()
        for _ in range(1000):
            loop.snap.refresh()
        out["refresh_us"] = (time.perf_counter() - t0) * 1e3
        return out

    lat, counts = run_path("serving loop: latency", latency,
                           ("unit_fold", "feature_hash"))
    paths["loop_latency"] = counts
    # resident orders: at most a window's worth after a tick, plus the
    # rows of one tick interval and one ingest chunk
    per_window = int(np.max(np.searchsorted(ts_o, ts_o + WINDOW_MS,
                                            side="right")
                            - np.arange(len(ts_o))))
    if lat["resident_orders"] > per_window + COMPACT_EVERY + LOOP_BATCH:
        raise AssertionError(f"orders not bounded: {lat['resident_orders']}"
                             f" > {per_window} + {COMPACT_EVERY} + "
                             f"{LOOP_BATCH}")
    if lat["binlog"] > 2 * COMPACT_EVERY + LOOP_BATCH:
        raise AssertionError(f"binlog not bounded: {lat['binlog']}")
    fl = lat["flush_launches"]
    if fl.get("unit_fold", 0) != 2 or fl.get("feature_hash", 0) != 1:
        raise AssertionError(f"one flush launched {fl}")
    for mode in ("deadline", "count_only", "mixed"):
        r = lat[mode]
        rest = {k: v for k, v in r.items()
                if k not in ("TP50", "TP99", "TP999", "max_ms")}
        log(f"(b) {mode}: TP50 {r['TP50']:.3f} / TP99 {r['TP99']:.3f} / "
            f"TP999 {r['TP999']:.3f} / max {r['max_ms']:.3f} ms; {rest}  "
            f"[{card}]")
    log(f"(b) sparse arrivals: Poisson, mean gap {lat['gap_ms']:.3f} ms (2x "
        f"the B=1 p50 {lat['b1_p50_ms']:.3f} ms); after the mixed loop: "
        f"{lat['resident_orders']} orders and {lat['resident_actions']} "
        f"actions resident, binlog {lat['binlog']} entries; "
        f"{len(compactions)} compactions in all, orders ones "
        f"{[round(x['s'] * 1e3, 2) for x in compactions if x['table'] == 'orders']} ms")
    log(f"(b) one flush of B={LOOP_BATCH}: launches {fl}; median of 50 "
        f"through the loop {lat['flush_loop_ms']:.3f} ms, request_batch "
        f"on the same snapshot {lat['flush_direct_ms']:.3f} ms; snapshot "
        f"refresh {lat['refresh_us']:.2f} us  [{card}]")
    log_profile(f"loop flush B={LOOP_BATCH}", lat["profile_flush"], card)

    # (c) a CPU-recorded trace replayed on the card
    lo_ts = cut_ts - TRACE_HISTORY_MS
    hist = {name: slice_table(t, int(np.searchsorted(
        t.columns["ts"], lo_ts, side="left")), cut)
        for (name, t), cut in zip((("actions", actions),
                                   ("orders", orders)), (cut_a, cut_o))}

    def trace_engine(device):
        e = FeatureEngine(SMOKE_SQL, tables, capacity=TRACE_CAPACITY,
                          device=device, **kw)
        for name, t in hist.items():
            e.bulk_load(name, t)
        return e

    loop_kw = dict(batch_size=LOOP_BATCH, max_wait_ms=LOOP_WAIT_MS,
                   slo_ms=LOOP_SLO_MS,
                   service_model=lambda n: 1.0 + 0.02 * n)
    rec, clock = TraceRecorder(), VirtualClock()
    t0 = time.perf_counter()
    rec_loop = ServeLoop(trace_engine("cpu"), clock=clock, recorder=rec,
                         **loop_kw)
    chunks = table_runs(stream[:TRACE_ROWS], max_rows=16)
    t = 0.0
    for k, (name, rows) in enumerate(chunks):
        t += 2e-3
        if k % 2 == 0:
            rec_loop.submit(ahead[(k // 2) % len(ahead)], now=t)
        rec_loop.ingest(name, rows, now=t)
        rec_loop.step(now=t)
        if k % 50 == 49:
            rec_loop.flush(now=t)
    rec_loop.flush(now=t + 1.0)
    rec_loop.drain_ingest(now=t + 1.0)
    t_rec = time.perf_counter() - t0
    n_orders = sum(name == "orders" for name, _ in stream[:TRACE_ROWS])
    if n_orders < 2 * COMPACT_EVERY or rec_loop.engine.store._binlog_base \
            == 0:
        raise AssertionError(f"the trace crossed no two orders ticks "
                             f"({n_orders} orders rows)")
    path = ROOT / "build" / "chip_smoke" / "loop_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    save_trace(rec.events, str(path))
    t0 = time.perf_counter()
    card_loop, counts = run_path(
        "serving loop: trace replay",
        lambda: replay(load_trace(str(path)),
                       lambda: trace_engine("cuda"), **loop_kw),
        ("unit_fold", "feature_hash"))
    t_replay = time.perf_counter() - t0
    paths["loop_replay"] = counts
    if card_loop.stats != rec_loop.stats:
        raise AssertionError(f"replay stats {card_loop.stats} != "
                             f"{rec_loop.stats}")
    ids = sorted(rec_loop.results)
    if sorted(card_loop.results) != ids:
        raise AssertionError("replay served other request ids")
    err_trace = compare_features([card_loop.results[i] for i in ids],
                                 [rec_loop.results[i] for i in ids])
    for (pa, a), (pb, b) in zip(store_state_arrays(card_loop.engine),
                                store_state_arrays(rec_loop.engine)):
        if pa != pb or a.tobytes() != b.tobytes():
            raise AssertionError(f"replayed store differs at {pa}")
    log(f"(c) trace of {len(rec.events)} events ({len(ids)} requests, "
        f"{TRACE_ROWS} streamed rows, {n_orders} orders rows) recorded on "
        f"the CPU in {t_rec:.1f} s, replayed on the card in "
        f"{t_replay:.1f} s: stats {card_loop.stats}; features equal "
        f"(bitwise, ew within rtol {EW_RTOL}; max abs diff {err_trace}); "
        f"final store bitwise")
    del rec_loop, card_loop

    # (d) the consistency gate through the loop
    gate = int_priced(prefix_tables(tables, GATE_LOOP_ROWS))
    n_gate = sum(len(t) for t in gate.values())

    def gate_engine():
        return FeatureEngine(SMOKE_SQL, gate, capacity=2 * n_gate,
                             fused_fold=True, retention="auto",
                             compact_every=GATE_LOOP_COMPACT, device="cuda")

    t0 = time.perf_counter()
    (g_loop, events, rids), counts = run_path(
        "serving loop: gate",
        lambda: record_consistency_trace(gate_engine(), gate),
        ("unit_fold", "feature_hash"))
    t_gate = time.perf_counter() - t0
    paths["loop_gate"] = counts
    g_cs = g_loop.engine.cs
    out = outputs_in_base_order(g_loop, rids, gate, g_cs)
    rep = verify_consistency(g_cs, gate, bitwise=True, online_outputs=out,
                             device="cuda")
    if not (rep.passed and rep.bitwise_equal):
        raise AssertionError(f"loop-driven gate: {rep}")
    evicted = n_gate - sum(g_loop.engine.store.n_rows(n) for n in gate)
    if evicted <= 0:
        raise AssertionError("the loop-driven gate evicted no row")
    gpath = path.with_name("gate_trace.json")
    save_trace(events, str(gpath))
    t0 = time.perf_counter()
    again = replay(load_trace(str(gpath)), gate_engine, batch_size=1,
                   max_wait_ms=0.0, slo_ms=1e6)
    t_again = time.perf_counter() - t0
    out2 = outputs_in_base_order(again, rids, gate, g_cs)
    for k in out:
        if out2[k].tobytes() != out[k].tobytes():
            raise AssertionError(f"gate replay: {k} differs")
    for (pa, a), (_, b) in zip(store_state_arrays(again.engine),
                               store_state_arrays(g_loop.engine)):
        if a.tobytes() != b.tobytes():
            raise AssertionError(f"gate replay store differs at {pa}")
    log(f"(d) record_consistency_trace on the card over {n_gate} rows "
        f"({len(rids)} requests; integer prices; {evicted} rows evicted "
        f"mid-trace, compact_every {GATE_LOOP_COMPACT}): {rep} in "
        f"{t_gate:.1f} s; replayed again in {t_again:.1f} s, bitwise "
        f"equal outputs and store  [{card}]")
    c_orders = [x for x in compactions if x["table"] == "orders"]
    return {"cut_ts": cut_ts, "bulk_load_s": t_load,
            "compactions": compactions,
            "first_compaction": c_orders[0], "err_cpu": err_cpu,
            "err_no_retention": err_plain, "latency": lat,
            "trace": {"events": len(rec.events), "requests": len(ids),
                      "record_s": t_rec, "replay_s": t_replay,
                      "max_abs_err": err_trace},
            "gate": {"rows": n_gate, "requests": len(rids),
                     "evicted": evicted, "s": t_gate,
                     "replay_s": t_again}}, paths


def widest_units(cs, tables):
    """(widest rp, [(rp, variant)] per unit block) of an offline plan."""
    from repro_torch.core.lowering import drivers
    from repro_torch.core.lowering.windows import (group_leaf_set,
                                                   unique_leaves)
    from repro_torch.kernels.unit_fold import ops
    from repro_torch.kernels.unit_fold.kernel import variant

    lws, _, _ = drivers.plan_offline(cs, tables)
    blocks = []
    for gl in lws:
        plan, _ = ops.plan_for(
            [m.node.spec for m in gl.members], group_leaf_set(gl.members),
            gl.members[0].node.spec.order_by,
            [tuple(unique_leaves(m.aggs)) for m in gl.members])
        for b in gl.blocks:
            rp = b.idx.shape[1]
            blocks.append((rp, variant(plan, rp, rp)))
    return max(rp for rp, _ in blocks), blocks


def prefix_tables(tables, n_rows: int):
    """The first ``n_rows`` events of the deployment (both tables cut at
    one timestamp)."""
    ts = np.sort(np.concatenate([t.columns["ts"] for t in tables.values()]))
    cut = ts[min(n_rows, ts.shape[0]) - 1]
    return {name: slice_table(t, 0, int(np.searchsorted(
        t.columns["ts"], cut, side="right")))
        for name, t in tables.items()}


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
    from repro_torch.core import compile_script, verify_consistency
    from repro_torch.core.lowering.windows import group_windows
    from repro_torch.data.synthetic import make_action_tables
    from repro_torch.kernels.batch_windowfold import store_windowfold
    from repro_torch.kernels.segagg import bucket_build
    from repro_torch.serve.engine import FeatureEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    phase("2 build")
    build_s = build_all(dev)

    phase("3 kernels against plain versions")
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
    # the consistency replay's shape: one unit, one query
    replay = {name: check_unit_fold(f"{name}/U1", fold_block(
        groups[name], 1, total[name], 1, seed, dev), 200)
        for name, seed in (("w", 7), ("wr", 8))}
    # offline shapes, Q = rp, every leaf family: rp = 2048 (the uniform
    # deployment's units, shared memory), 8192 and 16384 (w's min/max
    # sparse table past shared memory: the wide variant; wr's levels fit
    # up to 8192) and 32768 (the wide variant for both)
    offline_shapes = {}
    for name, u, r, seed in (("w/rp2048", 64, 2048, 3),
                             ("wr/rp2048", 64, 2048, 4),
                             ("w/rp8192", 8, 8192, 5),
                             ("wr/rp8192", 8, 8192, 6),
                             ("w/rp16384", 4, 16384, 9),
                             ("wr/rp16384", 4, 16384, 10),
                             ("w/rp32768", 2, 32768, 11),
                             ("wr/rp32768", 2, 32768, 12)):
        offline_shapes[name] = check_unit_fold(
            name, fold_block(groups[name.split("/")[0]], u, r, r, seed,
                             dev), 3)
    for name in ("w/rp32768", "wr/rp32768"):
        if offline_shapes[name]["variant"] != "wide":
            raise AssertionError(f"unit_fold[{name}] did not take the wide "
                                 f"variant")
    res_fh = check_feature_hash(dev, 50)

    phase("3c model kernels against plain versions (hymba-1.5b shapes)")
    res_ls = check_linear_scan(dev, 10)
    res_fd = check_decode_partials(dev, 50)
    torch.cuda.empty_cache()

    phase("4a serving path at deployment size")
    t0 = time.perf_counter()
    tables = make_action_tables(**DEPLOYMENT)
    actions, orders = tables["actions"], tables["orders"]
    n_act = len(actions)
    hist_end = n_act - N_LIVE - max(BATCHES)
    log(f"tables: {n_act} actions + {len(orders)} orders in "
        f"{time.perf_counter() - t0:.1f} s")
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
    served, counts = run_path(
        "serving", lambda: {b: eng.request_batch(reqs[:b])
                            for b in BATCHES},
        ("unit_fold", "feature_hash"))
    paths = {"serving": counts}
    for b, feats in served.items():
        if len(feats) != b or set(feats[0]) != set(cs.feature_names):
            raise AssertionError(f"request_batch B={b}: bad output shape")
    cpu = FeatureEngine(SMOKE_SQL, tables, capacity=CAPACITY,
                        fused_fold=True, device="cpu")
    cpu.load_store_from(store_arrays(eng))
    err = compare_features(served[64], cpu.request_batch(reqs[:64]))
    del cpu
    log(f"B=64 card vs CPU plain path: equal (bitwise; ew within rtol "
        f"{EW_RTOL}), max abs diff {err}")

    phase("4b offline path at deployment size")
    t0 = time.perf_counter()
    off, counts = run_path("offline", eng.offline, ("unit_fold",))
    t_off_cold = time.perf_counter() - t0
    paths["offline"] = counts
    plain_cs = compile_script(SMOKE_SQL, tables=tables,
                              unit_fold_kernel=False)
    err_off = compare_offline("offline", off,
                              plain_cs.offline(tables, device="cuda"), n_act)
    del plain_cs
    rp_uniform, blocks_uniform = widest_units(eng.cs, tables)
    log(f"offline over {n_act + len(orders)} rows: {len(off)} features x "
        f"{n_act} rows equal the plain fold on the card (bitwise; ew "
        f"within rtol {EW_RTOL}), max abs diff {err_off}; unit blocks "
        f"(rp, variant): {blocks_uniform}; first call {t_off_cold:.2f} s "
        f"(plan + upload + fold)")

    skewed = make_action_tables(**dict(DEPLOYMENT, zipf_alpha=SKEW_ALPHA))
    skew_eng = FeatureEngine(SMOKE_SQL, skewed, capacity=64,
                             fused_fold=True, device="cuda")
    t0 = time.perf_counter()
    off_skew, counts = run_path("offline (skewed)", skew_eng.offline,
                                ("unit_fold",))
    t_skew = time.perf_counter() - t0
    paths["offline_skewed"] = counts
    rp_skew, blocks_skew = widest_units(skew_eng.cs, skewed)
    n_wide = sum(v == "wide" for _, v in blocks_skew)
    if n_wide == 0 or counts["unit_fold"] != len(blocks_skew):
        raise AssertionError(f"skewed offline: {n_wide} wide blocks, "
                             f"{counts['unit_fold']} launches for "
                             f"{len(blocks_skew)} blocks")
    plain_cs = compile_script(SMOKE_SQL, tables=skewed,
                              unit_fold_kernel=False)
    err_skew = compare_offline("offline (skewed)", off_skew,
                               plain_cs.offline(skewed, device="cuda"),
                               len(skewed["actions"]))
    del plain_cs
    log(f"offline skewed (zipf {SKEW_ALPHA}): widest unit rp={rp_skew}; "
        f"{n_wide} of {len(blocks_skew)} unit blocks took the wide "
        f"variant {blocks_skew}; equal to the plain fold (max abs diff "
        f"{err_skew}); first call {t_skew:.2f} s")

    prefix = prefix_tables(tables, CONSISTENCY_ROWS)
    n_prefix = sum(len(t) for t in prefix.values())
    t0 = time.perf_counter()
    rep, counts = run_path(
        "consistency",
        lambda: verify_consistency(compile_script(SMOKE_SQL, tables=prefix),
                                   prefix, bitwise=True, device="cuda"),
        ("unit_fold",))
    t_cons = time.perf_counter() - t0
    paths["consistency"] = counts
    if not (rep.passed and rep.bitwise_equal):
        raise AssertionError(f"verify_consistency on the card: {rep}")
    log(f"verify_consistency on the card over {n_prefix} rows "
        f"({len(prefix['actions'])} requests): {rep} in {t_cons:.1f} s")

    phase("4e staged fold path at deployment size")
    staged, counts = staged_path(tables, eng, reqs, served, off, card)
    paths.update(counts)
    torch.cuda.empty_cache()

    phase("4f long windows (pre-aggregation) at deployment size")
    longw, counts = long_windows(card)
    paths.update(counts)
    torch.cuda.empty_cache()

    phase("4g serving loop at deployment size")
    t0 = time.perf_counter()
    loop_res, counts = serving_loop(tables, card)
    paths.update(counts)
    log(f"phase 4g took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    phase("4c additive folds (store_windowfold, bucket_build)")
    state = eng.store.tables["actions"]
    vals = store_vals(state)

    def additive():
        folds = {b: store_windowfold(state, vals,
                                     *request_frames(reqs[:b], dev))
                 for b in BATCHES}
        buckets = {s: bucket_build(*bucket_inputs(actions, ms, s, dev), ms,
                                   s) for ms, s in BUCKETS}
        return folds, buckets

    (folds, buckets), counts = run_path(
        "additive folds", additive, ("batch_windowfold", "segagg"))
    paths["additive"] = counts
    for b, out in folds.items():
        if tuple(out.shape) != (b, 2) or out.isnan().any() or not bool(
                (out[:, 1] == out[:, 1].round()).all()):
            raise AssertionError(f"store_windowfold B={b}: bad output")
    for s, out in buckets.items():
        if tuple(out.shape) != (s, 3):
            raise AssertionError(f"bucket_build S={s}: bad output")

    phase("3b additive-fold kernels against plain versions")
    res_bwf = check_batch_windowfold(state, reqs, dev, 20)
    res_seg, seg_shapes = check_bucket_build(actions, dev, 20)

    phase(f"4d model serving ({MODEL_ARCH}, full width and depth)")
    model, counts = model_serving(dev, card)
    paths.update(counts)

    phase("5 times")
    latency = latencies(eng.request_batch, reqs, N_LATENCY)
    log_latency("request_batch", latency, N_LATENCY, card)
    prof = profile_calls(lambda: eng.request_batch(reqs[:256]), 5)
    log_profile("request_batch B=256", prof, card)
    t0 = time.perf_counter()
    for _ in range(3):
        eng.offline()
    t_off = (time.perf_counter() - t0) / 3
    prof_off = profile_calls(eng.offline, 2)
    log(f"offline (plan cached) over {n_act + len(orders)} rows: wall "
        f"{t_off * 1e3:.1f} ms per call, {paths['offline']['unit_fold']} "
        f"unit-fold launches per call  [{card}]")
    log_profile("offline", prof_off, card)
    uf = {k: res_w[k] + res_wr[k] for k in ("ms", "plain_ms", "bound_ms")}
    launches = {k: sum(c.get(k, 0) for c in paths.values())
                for k in ("unit_fold", "feature_hash", "batch_windowfold",
                          "segagg", "linear_scan", "decode_partials")}
    kernels = [
        {"name": "unit_fold", "route": "cuda",
         "source": "src/repro_torch/kernels/unit_fold/csrc/unit_fold.cu",
         "replaces": "src/repro/kernels/unit_fold/kernel.py:278",
         "launches": launches["unit_fold"],
         "max_abs_err": max([res_w["max_abs_err"], res_wr["max_abs_err"]]
                            + [r["max_abs_err"] for r in
                               (*offline_shapes.values(),
                                *replay.values())]),
         "ms": uf["ms"], "plain_ms": uf["plain_ms"],
         "bound_ms": uf["bound_ms"], "bound_by": res_w["bound_by"],
         "library_ms": None},
        {"name": "feature_hash", "route": "triton",
         "source": "src/repro_torch/kernels/feature_hash/kernel.py",
         "replaces": "src/repro/kernels/feature_hash/kernel.py:32",
         "launches": launches["feature_hash"],
         "max_abs_err": res_fh["max_abs_err"], "ms": res_fh["ms"],
         "plain_ms": res_fh["plain_ms"], "bound_ms": res_fh["bound_ms"],
         "bound_by": res_fh["bound_by"], "library_ms": None},
        {"name": "batch_windowfold", "route": "cuda",
         "source": "src/repro_torch/kernels/batch_windowfold/csrc/"
                   "batch_windowfold.cu",
         "replaces": "src/repro/kernels/batch_windowfold/kernel.py:66",
         "launches": launches["batch_windowfold"], **res_bwf},
        {"name": "segagg", "route": "cuda",
         "source": "src/repro_torch/kernels/segagg/csrc/segagg.cu",
         "replaces": "src/repro/kernels/segagg/kernel.py:57",
         "launches": launches["segagg"], **res_seg},
        {"name": "linear_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/chunked_scan/csrc/"
                   "linear_scan.cu",
         "replaces": "src/repro/kernels/chunked_scan/kernel.py:68",
         "launches": launches["linear_scan"], **res_ls},
        {"name": "decode_partials", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_decode/csrc/"
                   "flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/kernel.py:77",
         "launches": launches["decode_partials"],
         **{k: v for k, v in res_fd["global"].items()
            if k not in ("live_keys", "cold_ms", "cold_library_ms",
                         "passes_ms")}},
    ]
    log(f"unit_fold main-path shapes (w + wr, B=256): ms {uf['ms']:.4f}, "
        f"plain {uf['plain_ms']:.4f}, bound {uf['bound_ms']:.5f}  [{card}]")
    for name, r in replay.items():
        log(f"unit_fold replay {name} (U=1, Q=1, {r['variant']}): ms "
            f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.5f}  [{card}]")
    for name, r in offline_shapes.items():
        log(f"unit_fold offline {name} ({r['variant']}): ms {r['ms']:.4f}, "
            f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.5f}  "
            f"[{card}]")
    log(f"feature_hash 2^20 codes: ms {res_fh['ms']:.4f}, plain "
        f"{res_fh['plain_ms']:.4f}, bound {res_fh['bound_ms']:.5f}  "
        f"[{card}]")
    log(f"linear_scan (8, 1024, 51,200): ms {res_ls['ms']:.4f}, plain "
        f"{res_ls['plain_ms']:.4f}, bound {res_ls['bound_ms']:.5f}  [{card}]")
    for name, r in res_fd.items():
        log(f"decode_partials {name} ({r['live_keys']} live keys): ms "
            f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f}; cold in L2 "
            f"ms {r['cold_ms']:.4f}, library {r['cold_library_ms']:.4f}  "
            f"[{card}]")
    for n_buckets, r in seg_shapes.items():
        log(f"segagg S={n_buckets}: ms {r['ms']:.4f}, index_add_ "
            f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.5f}; passes {r['passes_ms']}  [{card}]")
    log(f"launches per path: {paths}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if json_path:
        out = pathlib.Path(json_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({
            "card": card, "kernels": kernels, "latency": latency,
            "build_s": build_s,
            "unit_fold_shapes": dict(offline_shapes, w=res_w, wr=res_wr,
                                     **{f"{k}/U1": v
                                        for k, v in replay.items()}),
            "profile_requests": prof, "profile_offline": prof_off,
            "offline": {"wall_ms_cached": t_off * 1e3,
                        "first_call_s": t_off_cold,
                        "skewed_first_call_s": t_skew,
                        "blocks_uniform": blocks_uniform,
                        "blocks_skewed": blocks_skew,
                        "widest_rp_skewed": rp_skew,
                        "consistency_rows": n_prefix,
                        "consistency_s": t_cons},
            "launches_per_path": paths, "model_serving": model,
            "staged": staged, "long_windows": longw,
            "serving_loop": loop_res,
            "decode_partials_shapes": res_fd, "segagg_shapes": seg_shapes,
            "load_s": t_load, "ingest_s": t_ingest}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
