"""The port's kernels on the card, against their plain versions.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one.  The file imports neither JAX nor the JAX package, so it also runs
on a GPU host that has only PyTorch and Triton:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

Bitwise everywhere, except the EW lanes at ``EW_RTOL``/``EW_ATOL`` (an
``expf`` ulp carried by the fold) and the kernels whose sums run in
another order than their plain versions (each case states its bar).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import compile_script
from repro_torch.core.lowering import windows as TW
from repro_torch.core.types import Table
from repro_torch.data.synthetic import make_action_tables
from repro_torch.kernels import dispatch
from repro_torch.kernels.feature_hash import ops as fh_ops
from repro_torch.kernels.feature_hash.ref import feature_hash_ref
from repro_torch.kernels.unit_fold import ops as uf_ops
from repro_torch.serve import ServeLoop, VirtualClock
from repro_torch.serve.engine import FeatureEngine

from torch_port_cases import (EW_ATOL, EW_RTOL, SMOKE_SQL, SQLS,
                              require_cuda, unit_block)


def _group(sql, **ctx):
    cs = compile_script(sql, fused_unit_fold=True, **ctx)
    (members,) = TW.group_windows(cs.windows)
    return ([m.node.spec for m in members], TW.group_leaf_set(members),
            [tuple(TW.unique_leaves(m.aggs)) for m in members])


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["family", "edge", "solo", "hll"])
@pytest.mark.parametrize("q1", [False, True], ids=["all-rows", "one-query"])
def test_unit_fold_kernel_matches_plain(which, q1):
    """``hll`` stacks a 256-register sketch with max(price): at rp = 1024
    its sparse table spans several lane tiles, one block each."""
    dev = require_cuda()
    if which == "hll":
        specs, leaves, mk = _group(SQLS["family"], distinct_hll_p=8,
                                   distinct_hll_min_card=8)
        u, r = 5, 600
    else:
        specs, leaves, mk = _group(SQLS[which])
        u, r = 9, 37
    # NULL (NaN) prices: at a unit's last row, mid-unit, and in an invalid
    # slot, which the mask must hide
    env = {k: torch.from_numpy(v).to(dev) for k, v in
           unit_block(u, r, seed=2, n_valid=[r, 0] + [20] * (u - 2),
                      nan_rows=[(0, r - 1), (2, 10), (3, 30)]).items()}
    q = (torch.tensor([[i % r] for i in range(u)], dtype=torch.int32,
                      device=dev) if q1 else None)
    before = dispatch.launch_counts().get("unit_fold", 0)
    got = uf_ops.unit_fold(specs, leaves, env, q, order_by="ts",
                           member_keys=mk, use_kernel=True)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["unit_fold"] == before + 1
    want = uf_ops.unit_fold(specs, leaves, env, q, order_by="ts",
                            member_keys=mk, use_kernel=False)
    for g, w in zip(got, want):
        for k in w:
            tol = ((EW_RTOL, EW_ATOL) if k.startswith("ew:") else (0, 0))
            torch.testing.assert_close(g[k], w[k], rtol=tol[0], atol=tol[1],
                                       equal_nan=True, msg=k)


def _fold_direct(sql, u, r, queries, seed, edit=None, **ctx):
    """The kernel on unpadded (U, R) rows against the plain version on
    the rows padded to rp; ``edit(price)`` changes the numpy prices."""
    from repro_torch.kernels.unit_fold import kernel as K, ref

    dev = require_cuda()
    specs, leaves, mk = _group(sql, **ctx)
    plan, idents = uf_ops.plan_for(specs, leaves, "ts", mk, device=dev)
    env_np = unit_block(u, r, seed=seed)
    if edit is not None:
        edit(env_np["price"])
    env = {k: torch.from_numpy(v).to(dev) for k, v in env_np.items()}
    data = [ref.lift_group(g, env, (u, r)).contiguous()
            for g in plan.groups]
    ts = env["ts"].to(torch.int32).contiguous()
    q = (torch.arange(r, dtype=torch.int32, device=dev).expand(u, r)
         if queries is None else
         torch.tensor(queries, dtype=torch.int32, device=dev).reshape(u, -1))
    q = q.contiguous()
    got = K.unit_fold_cuda(plan, data, idents, ts, q)
    again = K.unit_fold_cuda(plan, data, idents, ts, q)
    torch.cuda.synchronize()
    pdata, pts = uf_ops.pad_rows(idents, data, ts)
    want = ref.unit_fold_plain(plan, pdata, idents, pts, q, r)
    for g, a, b, c in zip(plan.groups, got, want, again):
        assert torch.equal(a.isnan(), c.isnan())
        assert torch.equal(a.nan_to_num(), c.nan_to_num())
        tol = (EW_RTOL, EW_ATOL) if g.family == "ew" else (0, 0)
        torch.testing.assert_close(a, b, rtol=tol[0], atol=tol[1],
                                   equal_nan=True, msg=g.family)
    return K.variant(plan, r, q.shape[1])


@pytest.mark.gpu
@pytest.mark.parametrize("u", [1, 7])
@pytest.mark.parametrize("r", [257, 513])
def test_unit_fold_kernel_unpadded_rows(r, u):
    """R not a power of two, given unpadded (the kernel makes rows R..rp
    identity), one query per unit at its last row, at row 0 and mid-unit,
    U = 1 as the consistency replay launches it."""
    queries = [[(r - 1, 0, r // 2)[i % 3]] for i in range(u)]
    assert _fold_direct(SQLS["edge"], u, r, queries, seed=r + u) == "few"
    _fold_direct(SQLS["family"], u, r, queries, seed=r + u + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("q1", [False, True], ids=["all-rows", "one-query"])
def test_unit_fold_kernel_edge_values(q1):
    """A query at row 0 and empty frames (EXCLUDE CURRENT_ROW at row 0),
    -0.0 and +-Inf in the ADD lanes, and NULL (NaN) prices on 32-row node
    boundaries (rows 31, 32, 63, 64, 127, 128)."""
    def edit(price):
        price[0, 5::9] = -0.0
        price[1, 40] = np.inf
        price[1, 90] = -np.inf
        price[2, 70] = np.inf
        for row in (31, 32, 63, 64, 127, 128):
            price[3, row] = np.nan

    u, r = 5, 150
    queries = [[0], [r - 1], [80], [64], [0]] if q1 else None
    _fold_direct(SQLS["family"], u, r, queries, seed=3, edit=edit)


@pytest.mark.gpu
@pytest.mark.parametrize("u,rp,kind", [(4, 2048, "shared"),
                                       (2, 8192, "wide"),
                                       (1, 16384, "wide")])
def test_unit_fold_kernel_offline_shapes(u, rp, kind):
    """Offline units queried at every row (Q = rp), every family: shared
    memory at rp = 2048, the wide variant where the min/max sparse table
    no longer fits."""
    assert _fold_direct(SQLS["edge"], u, rp, None, seed=rp) == kind
    _fold_direct(SQLS["family"], u, rp, None, seed=rp + 1)


@pytest.mark.gpu
def test_feature_hash_kernel_matches_plain():
    dev = require_cuda()
    pytest.importorskip("triton")
    rng = np.random.default_rng(1)
    codes = rng.integers(-2**31, 2**31, 1 << 16).astype(np.int32)
    codes[:4] = [0, -1, 2**31 - 1, -2**31]
    codes = torch.from_numpy(codes).to(dev)
    got = fh_ops.feature_hash(codes, 1 << 20, use_kernel=True)
    assert torch.equal(got.cpu(), feature_hash_ref(codes.cpu(), 1 << 20))


@pytest.mark.gpu
def test_feature_hash_kernel_on_every_card():
    """The hash kernel on codes held by each visible card, the current
    card staying card 0, equals the plain version: the launch runs on
    the codes' card (a mesh engine hashes each shard's features there)."""
    require_cuda()
    pytest.importorskip("triton")
    codes = torch.from_numpy(np.random.default_rng(4).integers(
        -2**31, 2**31, 1 << 16).astype(np.int32))
    want = feature_hash_ref(codes, 1 << 20)
    for i in range(torch.cuda.device_count()):
        got = fh_ops.feature_hash(codes.to(torch.device("cuda", i)),
                                  1 << 20, use_kernel=True)
        assert got.device.index == i
        assert torch.equal(got.cpu(), want), i


@pytest.mark.gpu
def test_engine_on_card_matches_cpu_engine():
    require_cuda()
    tables = make_action_tables(n_actions=3000, n_orders=1500, n_users=10,
                                horizon_ms=600_000, seed=3,
                                with_profile=False)
    actions = tables["actions"]
    engines = [FeatureEngine(SMOKE_SQL, tables, capacity=5000,
                             fused_fold=True, device=d)
               for d in ("cuda", "cpu")]
    for eng in engines:
        eng.bulk_load("orders", tables["orders"])
        eng.ingest_many("actions", [actions.row(i) for i in range(2000)])
    rows = [dict(actions.row(2000 + i)) for i in range(37)]
    dispatch.reset_launch_counts()
    gpu = engines[0].request_batch(rows)
    counts = dispatch.launch_counts()
    assert counts.get("unit_fold", 0) == 2
    assert counts.get("feature_hash", 0) == 1
    cpu = engines[1].request_batch(rows)
    for a, b in zip(gpu, cpu):
        for k in a:
            if k == "ew":
                np.testing.assert_allclose(a[k], b[k], rtol=EW_RTOL,
                                           atol=EW_ATOL)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_rows(a_rows, b_rows, loose=("ew",)):
    for a, b in zip(a_rows, b_rows):
        assert set(a) == set(b)
        for k in a:
            if k in loose:
                np.testing.assert_allclose(a[k], b[k], rtol=EW_RTOL,
                                           atol=EW_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.gpu
def test_staged_fold_on_card_matches_fused():
    """``fused_fold=False`` on the card (plain torch ops, no unit-fold
    launch) against the fused kernel path: requests, single requests
    and ``offline()``."""
    require_cuda()
    tables = make_action_tables(n_actions=3000, n_orders=1500, n_users=10,
                                horizon_ms=600_000, seed=5,
                                with_profile=False)
    actions = tables["actions"]
    fused, staged = (FeatureEngine(SMOKE_SQL, tables, capacity=5000,
                                   fused_fold=f, device="cuda")
                     for f in (True, False))
    for eng in (fused, staged):
        eng.bulk_load("orders", tables["orders"])
        eng.ingest_many("actions", [actions.row(i) for i in range(2000)])
    rows = [dict(actions.row(2000 + i)) for i in range(37)]
    dispatch.reset_launch_counts()
    got = staged.request_batch(rows)
    assert dispatch.launch_counts().get("unit_fold", 0) == 0
    _assert_rows(got, fused.request_batch(rows))
    _assert_rows([staged.request(rows[0])], got[:1], loose=())
    off_s, off_f = staged.offline(), fused.offline()
    for k in off_f:
        if k == "ew":
            np.testing.assert_allclose(off_s[k], off_f[k], rtol=EW_RTOL,
                                       atol=EW_ATOL)
        else:
            np.testing.assert_array_equal(off_s[k], off_f[k], err_msg=k)


LONG_SQL = """
SELECT sum(price) OVER wl AS s_l, count(price) OVER wl AS c_l,
  min(price) OVER wl AS mn_l, max(price) OVER wl AS mx_l,
  distinct_count(category) OVER wl AS dc_l,
  drawdown(price) OVER wl AS dd_l, ew_avg(price, 0.5) OVER wl AS ew_l,
  sum(price) OVER w AS s
FROM actions
WINDOW wl AS (UNION orders PARTITION BY userid ORDER BY ts
              ROWS_RANGE BETWEEN 3000s PRECEDING AND CURRENT ROW),
       w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 10s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "wl:100s")
"""


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_preagg_on_card_matches_cpu(fused):
    """Pre-agg planes after bulk load and ingest, and long-window
    requests, on the card against the CPU port: planes bitwise (drawdown
    and EW within rtol 1e-5), features bitwise (drawdown, EW within
    ``EW_RTOL``)."""
    require_cuda()
    tables = make_action_tables(n_actions=2000, n_orders=1000, n_users=6,
                                horizon_ms=12_000_000, seed=6,
                                with_profile=False)
    actions = tables["actions"]
    engines = [FeatureEngine(LONG_SQL, tables, capacity=4000,
                             use_preagg=True, fused_fold=fused, device=d)
               for d in ("cuda", "cpu")]
    for eng in engines:
        eng.bulk_load("orders", tables["orders"])
        eng.bulk_load("actions", Table(
            actions.schema, {c: v[:1500] for c, v in
                             actions.columns.items()}, dicts=actions.dicts))
        eng.ingest_many("actions", [actions.row(i)
                                    for i in range(1500, 1900)])
    gpu, cpu = (e.pre_states[0] for e in engines)
    for lvl in ("fine", "coarse"):
        for k, v in cpu[lvl].items():
            a, b = gpu[lvl][k].cpu().numpy(), v.numpy()
            if k.startswith(("dd:", "ew:")):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
        np.testing.assert_array_equal(gpu[f"{lvl}_epoch"].cpu().numpy(),
                                      cpu[f"{lvl}_epoch"].numpy())
    rows = [dict(actions.row(1900 + i)) for i in range(33)]
    _assert_rows(engines[0].request_batch(rows),
                 engines[1].request_batch(rows), loose=("dd_l", "ew_l"))


def _serving_tables(seed):
    tables = make_action_tables(n_actions=1200, n_orders=800, n_users=6,
                                horizon_ms=1_200_000, seed=seed,
                                with_profile=False)
    for t in tables.values():          # integer prices: exact sums
        t.columns["price"] = np.floor(t.columns["price"]).astype(np.float32)
    return tables


def _merged_rows(tables, lo, hi):
    """Rows ``lo:hi`` of both tables merged in ts order, as ingest
    batches of one table each."""
    ev = sorted((int(t.columns["ts"][i]), name, i)
                for name, t in tables.items() for i in range(len(t)))[lo:hi]
    out = []
    for _, name, i in ev:
        if not out or out[-1][0] != name:
            out.append((name, []))
        out[-1][1].append(tables[name].row(i))
    return out


@pytest.mark.gpu
def test_snapshot_isolated_from_compaction_on_card():
    """A snapshot on the card serves the same bytes before and after an
    ``ingest_many`` that compacts the live store, and after ``refresh()``
    the bytes of a CPU engine on copies of the compacted store."""
    require_cuda()
    tables = _serving_tables(9)
    eng = FeatureEngine(SMOKE_SQL, tables, capacity=4000, fused_fold=True,
                        retention="auto", compact_every=64, device="cuda")
    assert eng.retention_ms == {"actions": None, "orders": 60000}
    for name, rows in _merged_rows(tables, 0, 1000):
        eng.ingest_many(name, rows)
    snap = eng.snapshot()
    probe = [dict(tables["actions"].row(i)) for i in range(1100, 1132)]
    dispatch.reset_launch_counts()
    before = eng.request_batch(probe, snapshot=snap)
    assert dispatch.launch_counts().get("unit_fold", 0) == 2
    n_orders = eng.store.n_rows("orders")
    for name, rows in _merged_rows(tables, 1000, 1600):
        eng.ingest_many(name, rows)
    assert eng.store.n_rows("orders") < n_orders + 600
    _assert_rows(eng.request_batch(probe, snapshot=snap), before, loose=())
    snap.refresh()
    got = eng.request_batch(probe, snapshot=snap)
    cpu = FeatureEngine(SMOKE_SQL, tables, capacity=4000, fused_fold=True,
                        device="cpu")
    cpu.load_store_from({t: {"keys": st["keys"].cpu().numpy(),
                             "ts": st["ts"].cpu().numpy(),
                             "count": st["count"].cpu().numpy(),
                             "cols": {c: v.cpu().numpy()
                                      for c, v in st["cols"].items()}}
                         for t, st in eng.store.tables.items()})
    _assert_rows(got, cpu.request_batch(probe))


@pytest.mark.gpu
def test_cpu_recorded_trace_replays_on_card(tmp_path):
    """A mixed trace recorded on a CPU engine replays through a card
    engine: the same served bytes (``ew`` within ``EW_RTOL``) and the
    same final store, bit for bit."""
    from repro_torch.serve import trace

    require_cuda()
    tables = _serving_tables(10)
    kw = dict(capacity=4000, fused_fold=True, retention="auto",
              compact_every=64)
    loop_kw = dict(batch_size=8, max_wait_ms=2.0, slo_ms=25.0,
                   service_model=lambda n: 0.5 + 0.05 * n)
    rec = trace.TraceRecorder()
    cpu = ServeLoop(FeatureEngine(SMOKE_SQL, tables, device="cpu", **kw),
                    clock=VirtualClock(), recorder=rec, **loop_kw)
    for name, rows in _merged_rows(tables, 0, 1000):
        cpu.ingest(name, rows, now=0.0)
    cpu.drain_ingest(now=0.0)
    t = 0.0
    for k, (name, rows) in enumerate(_merged_rows(tables, 1000, 1800)):
        t += 1e-3
        cpu.submit(dict(tables["actions"].row(1000 + k % 190)), now=t)
        cpu.ingest(name, rows, now=t)
        cpu.step(now=t)
    cpu.flush(now=t + 1.0)
    cpu.drain_ingest(now=t + 1.0)
    path = str(tmp_path / "trace.json")
    trace.save_trace(rec.events, path)
    gpu = trace.replay(trace.load_trace(path), lambda: FeatureEngine(
        SMOKE_SQL, tables, device="cuda", **kw), **loop_kw)
    assert gpu.stats == cpu.stats and sorted(gpu.results) == \
        sorted(cpu.results)
    assert cpu.engine.store._binlog_base > 0
    ids = sorted(cpu.results)
    _assert_rows([gpu.results[i] for i in ids], [cpu.results[i] for i in ids])
    for (pa, a), (pb, b) in zip(trace.store_state_arrays(gpu.engine),
                                trace.store_state_arrays(cpu.engine)):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=pa)


def _bwf_inputs(c, f, b, seed, dev):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 16, size=c)).astype(np.int32)
    ts = rng.integers(0, 10_000, size=c).astype(np.int32)
    vals = rng.normal(size=(c, f)).astype(np.float32)
    qkey = rng.integers(0, 16, size=b).astype(np.int32)
    qt1 = rng.integers(0, 10_000, size=b).astype(np.int32)
    qt0 = qt1 - rng.integers(0, 3_000, size=b).astype(np.int32)
    keys[-1], vals[-1, 0] = 99, np.nan     # NaN in a row no request matches
    return [torch.from_numpy(a).to(dev) for a in
            (keys, ts, vals, qkey, qt0, qt1)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,f,b", [(64, 1, 3), (500, 9, 37),
                                   (130, 17, 130), (20_000, 2, 256)])
def test_batch_windowfold_kernel_matches_plain(c, f, b):
    """rtol/atol 1e-5 (the kernel sums rows in chunks, the plain version
    in matrix products), NaN positions equal, two runs bitwise equal."""
    from repro_torch.kernels.batch_windowfold import batch_windowfold

    dev = require_cuda()
    args = _bwf_inputs(c, f, b, seed=c, dev=dev)
    before = dispatch.launch_counts().get("batch_windowfold", 0)
    got = batch_windowfold(*args, use_kernel=True)
    again = batch_windowfold(*args, use_kernel=True)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["batch_windowfold"] == before + 2
    assert torch.equal(got.isnan(), again.isnan())
    assert torch.equal(got.nan_to_num(), again.nan_to_num())
    want = batch_windowfold(*args, use_kernel=False)
    assert got[:, 0].isnan().all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)


@pytest.mark.gpu
def test_store_windowfold_kernel_masks_dead_rows():
    from repro_torch.kernels.batch_windowfold import store_windowfold
    from repro_torch.storage.timestore import OnlineStore

    dev = require_cuda()
    rng = np.random.default_rng(1)
    n, cap = 3000, 4096
    store = OnlineStore(capacity=cap, device=dev)
    store.create_table("a", {"price": np.float32})
    store.bulk_load("a", rng.integers(0, 8, n), rng.integers(0, 90_000, n),
                    {"price": rng.uniform(1, 100, n).astype(np.float32)})
    st = store.tables["a"]
    vals = torch.stack([st["cols"]["price"], torch.ones_like(
        st["cols"]["price"])], dim=1)
    vals[n:] = float("nan")
    q = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 8, 64).astype(np.int32),
        rng.integers(0, 30_000, 64).astype(np.int32))]
    qt1 = q[1] + 60_000
    got = store_windowfold(st, vals, q[0], q[1], qt1, use_kernel=True)
    want = store_windowfold(st, vals, q[0], q[1], qt1, use_kernel=False)
    assert not got.isnan().any()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _dense_design(keys, ts, vals, qkey, qt0, qt1, count=None):
    """The dense design's arithmetic on the CPU: per 4,096-row
    chunk acc = acc + m * v over every row in row order (rows past the
    live count read as 0), then the chunk partials added in order."""
    keys, ts, vals, qkey, qt0, qt1 = (x.cpu() for x in
                                      (keys, ts, vals, qkey, qt0, qt1))
    c, f = vals.shape
    live = c if count is None else min(int(count), c)
    vals = vals.clone()
    vals[live:] = 0.0
    out = torch.zeros((qkey.shape[0], f))
    for lo in range(0, c, 4096):
        acc = torch.zeros_like(out)
        for i in range(lo, min(c, lo + 4096)):
            m = ((keys[i] == qkey) & (ts[i] >= qt0) & (ts[i] <= qt1)).float()
            acc = acc + m[:, None] * vals[i][None, :]
        out = out + acc
    return out


def _store(c, f, b, seed, dev, sort=True):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 12, c).astype(np.int32)
    ts = rng.integers(0, 100_000, c).astype(np.int32)
    if sort:
        order = np.lexsort((ts, keys))
        keys, ts = keys[order], ts[order]
    vals = rng.normal(size=(c, f)).astype(np.float32)
    pick = rng.integers(0, c, b)
    qkey, qt1 = keys[pick].copy(), ts[pick].copy()
    qt0 = (qt1 - 5_000).astype(np.int32)
    return keys, ts, vals, qkey, qt0, qt1, pick


def _bwf_check(arrays, dev, count=None):
    from repro_torch.kernels.batch_windowfold.kernel import \
        batch_windowfold_cuda

    args = [torch.from_numpy(a.copy()).to(dev) for a in arrays]
    cnt = (None if count is None
           else torch.tensor(count, dtype=torch.int32, device=dev))
    got = batch_windowfold_cuda(*args, count=cnt)
    again = batch_windowfold_cuda(*args, count=cnt)
    torch.cuda.synchronize()
    want = _dense_design(*args, count=count)
    got = got.cpu()
    assert torch.equal(got.isnan(), again.cpu().isnan())
    assert torch.equal(got.nan_to_num(), again.cpu().nan_to_num())
    # bitwise equal to the dense design (NaN at the same places)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~got.isnan()], want[~want.isnan()])
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_batch_windowfold_kernel_equals_dense_design(sort):
    """A store sorted by (key, ts), where requests skip most chunks and
    groups, and an unsorted one, where no chunk can be skipped: the
    kernel's bits equal the dense design's on the same inputs (and the
    plain version's at rtol 1e-5)."""
    from repro_torch.kernels.batch_windowfold.ref import \
        batch_windowfold_ref

    dev = require_cuda()
    arrays = _store(13_000, 3, 300, seed=21 + sort, dev=dev, sort=sort)[:6]
    got = _bwf_check(arrays, dev)
    want = batch_windowfold_ref(*(torch.from_numpy(a) for a in arrays))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_batch_windowfold_kernel_non_finite_rows():
    """A +Inf in a row request 0 matches gives it +Inf (every other
    request NaN or Inf: the dense product's 0 * Inf); a -Inf and a NaN in
    a chunk no request reaches turn their lanes NaN for every request."""
    dev = require_cuda()
    keys, ts, vals, qkey, qt0, qt1, pick = _store(13_000, 3, 40, seed=23,
                                                  dev=dev)
    keys[:4096] = -1                   # chunk 0: a key no request has
    pick = 4096 + pick % (keys.shape[0] - 4096)
    qkey, qt1 = keys[pick].copy(), ts[pick].copy()
    qt0 = (qt1 - 5_000).astype(np.int32)
    vals[pick[0], 0] = np.inf
    vals[100, 1] = -np.inf
    vals[200, 2] = np.nan
    got = _bwf_check((keys, ts, vals, qkey, qt0, qt1), dev)
    assert got[0, 0] == float("inf")
    assert bool((got[:, 0].isnan() | (got[:, 0] == float("inf"))).all())
    assert bool(got[:, 1:].isnan().all())


@pytest.mark.gpu
def test_batch_windowfold_kernel_garbage_past_count():
    """Rows at or past the live count hold matching keys and NaN values:
    they read as 0 (store_windowfold's contract)."""
    dev = require_cuda()
    keys, ts, vals, qkey, qt0, qt1, _ = _store(9_000, 2, 64, seed=25,
                                               dev=dev)
    count = 7_001
    keys[count:] = qkey[0]
    ts[count:] = qt1[0]
    vals[count:] = np.nan
    got = _bwf_check((keys, ts, vals, qkey, qt0, qt1), dev, count=count)
    assert not bool(got.isnan().any())


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,s,ids", [
    (64, 4, 8, "mixed"), (1000, 16, 50, "mixed"), (100_000, 3, 600, "mixed"),
    (100_000, 3, 36_000, "mixed"), (300_000, 3, 600, "one-segment"),
    (50_000, 5, 600, "out-of-range"), (1_000_000, 3, 36_000, "uniform")])
def test_segagg_kernel_matches_plain(n, f, s, ids):
    """rtol 1e-4 against the plain version (whose index_add_ adds in no
    fixed order on the card); the kernel's two runs are bitwise equal; a
    NaN stays in its segment; out-of-range ids are dropped.  ``mixed``:
    half the rows sorted, ids from -3 to S + 2; ``one-segment``: every
    row in segment 1 (one run through every row block); ``out-of-range``:
    every id outside [0, S); ``uniform``: ids drawn uniformly from
    [0, S)."""
    from repro_torch.kernels.segagg import segagg

    dev = require_cuda()
    rng = np.random.default_rng(n + s)
    vals = rng.uniform(1, 100, (n, f)).astype(np.float32)
    segs = {"mixed": rng.integers(-3, s + 3, n),
            "one-segment": np.ones(n),
            "out-of-range": np.where(rng.random(n) < 0.5,
                                     -rng.integers(1, 2**31, n),
                                     rng.integers(s, 2**31, n)),
            "uniform": rng.integers(0, s, n)}[ids].astype(np.int32)
    if ids == "mixed":
        segs[: n // 2] = np.sort(segs[: n // 2])
    vals[5, 0] = np.nan
    vals_t, segs_t = (torch.from_numpy(vals).to(dev),
                      torch.from_numpy(segs).to(dev))
    got = segagg(vals_t, segs_t, s, use_kernel=True)
    again = segagg(vals_t, segs_t, s, use_kernel=True)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), again.isnan())
    assert torch.equal(got.nan_to_num(), again.nan_to_num())
    want = segagg(vals_t, segs_t, s, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3,
                               equal_nan=True)
    assert int(got.isnan().sum()) == (1 if 0 <= segs[5] < s else 0)
    if ids == "out-of-range":
        assert not bool(got.any())


@pytest.mark.gpu
@pytest.mark.parametrize("rp_rows", [700, 5000])
def test_offline_unit_fold_kernel_matches_plain(rp_rows):
    """An offline block at Q = rp: 700 rows (rp 1024, shared-memory
    variant) and 5,000 rows (rp 8192, the wide global-memory variant)."""
    from repro_torch.core.lowering import drivers

    require_cuda()
    tables = make_action_tables(n_actions=rp_rows, n_orders=0, n_users=1,
                                horizon_ms=600_000, seed=5,
                                with_profile=False)
    sql = SMOKE_SQL.replace("UNION orders ", "")
    gpu_cs = compile_script(sql, tables=tables, offline_max_slices=1)
    dispatch.reset_launch_counts()
    got = gpu_cs.offline(tables, device="cuda")
    lws, _, _ = drivers.plan_offline(gpu_cs, tables)
    # one launch per unit block: one group (both windows share the
    # layout), one key, one unit
    assert dispatch.launch_counts()["unit_fold"] == \
        sum(len(gl.blocks) for gl in lws) == 1
    rp = lws[0].blocks[0].idx.shape[1]
    assert (rp >= 4096) == (rp_rows == 5000)
    plain = compile_script(sql, tables=tables, offline_max_slices=1,
                           unit_fold_kernel=False).offline(tables,
                                                           device="cuda")
    cpu = compile_script(sql, tables=tables,
                         offline_max_slices=1).offline(tables, device="cpu")
    for want in (plain, cpu):
        for k in want:
            if k == "ew":
                np.testing.assert_allclose(got[k], want[k], rtol=EW_RTOL,
                                           atol=EW_ATOL)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d", [(1, 64, 8), (3, 1000, 37),
                                   (2, 256, 51_200)])
def test_linear_scan_kernel_matches_plain(b, t, d):
    """Bitwise: the kernel repeats the plain version's sequential
    recurrence with the same two roundings per step (``--fmad=false``)."""
    from repro_torch.kernels.chunked_scan import linear_scan

    dev = require_cuda()
    rng = np.random.default_rng(t)
    a = torch.from_numpy(rng.uniform(0.3, 1.0, (b, t, d)).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
        np.float32)).to(dev)
    before = dispatch.launch_counts().get("linear_scan", 0)
    got = linear_scan(a, x, use_kernel=True)
    again = linear_scan(a, x, use_kernel=True)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["linear_scan"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, linear_scan(a, x, use_kernel=False))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d", [(1, 64, 8), (3, 1000, 37), (2, 1, 5),
                                   (2, 2048, 51_200)])
def test_linear_scan_bwd_kernel_matches_plain(b, t, d):
    """Bitwise: the backward kernel repeats ``linear_scan_bwd_ref``'s
    reverse recurrence with the same roundings; two runs equal.  Through
    autograd (T = 1000 pads to 1024 on the kernel route), the op's
    gradients equal the plain route's."""
    from repro_torch.kernels.chunked_scan import linear_scan
    from repro_torch.kernels.chunked_scan.kernel import linear_scan_bwd_cuda
    from repro_torch.kernels.chunked_scan.ref import (linear_scan_bwd_ref,
                                                      linear_scan_ref)

    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(t)
    a = torch.rand((b, t, d), generator=gen, device=dev) * 0.7 + 0.3
    x = torch.randn((b, t, d), generator=gen, device=dev)
    g = torch.randn((b, t, d), generator=gen, device=dev)
    y = linear_scan_ref(a, x)
    before = dispatch.launch_counts().get("linear_scan_bwd", 0)
    got = linear_scan_bwd_cuda(a, y, g)
    again = linear_scan_bwd_cuda(a, y, g)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["linear_scan_bwd"] == before + 2
    for k, r, w in zip(got, again, linear_scan_bwd_ref(a, y, g)):
        assert torch.equal(k, r) and torch.equal(k, w)
    if d > 1000:
        return
    grads = []
    for use_kernel in (True, False):
        la, lx = a.clone().requires_grad_(), x.clone().requires_grad_()
        linear_scan(la, lx, use_kernel=use_kernel).backward(g)
        grads.append((la.grad, lx.grad))
    for k, p in zip(*grads):
        assert torch.equal(k, p)


@pytest.mark.gpu
def test_train_step_on_card_matches_plain():
    """A 4-layer reduced hymba (one sliding-window layer), float32, two
    microbatches of 150 tokens: ``loss_and_grads`` through the scan
    kernels equals the plain route bit for bit; 2 forward launches
    (forward and remat recompute) and 1 backward launch per hybrid layer
    and microbatch; one train step runs and changes the params."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed.fault import tree_flatten
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init, build_train_step
    from repro_torch.train.steps import loss_and_grads

    dev = require_cuda()
    cfg = dataclasses.replace(reduced("hymba-1.5b"), n_layers=4)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 150)).astype(np.int32)).to(dev)}
    dispatch.reset_launch_counts()
    kern = loss_and_grads(cfg, params, batch, n_micro=2,
                          compute_dtype=torch.float32)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    assert counts["linear_scan"] == 16 and counts["linear_scan_bwd"] == 8
    plain = loss_and_grads(cfg, params, batch, n_micro=2,
                           compute_dtype=torch.float32, use_kernel=False)
    assert torch.equal(kern[0], plain[0])
    for k, p in zip(tree_flatten(kern[1])[0], tree_flatten(plain[1])[0]):
        assert torch.equal(k, p)
    state = adamw_init(params)
    step = build_train_step(cfg, AdamWConfig(lr=1e-3), n_micro=2,
                            compute_dtype=torch.bfloat16)
    state, metrics = step(state, batch)
    assert int(metrics["step"]) == 1
    assert bool(torch.isfinite(metrics["loss"]))
    assert not torch.equal(state.params["embed"], params["embed"])


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 32), (25, 5, 64),
                                      (32, 8, 128), (16, 16, 128),
                                      (48, 8, 128), (56, 8, 128),
                                      (6, 6, 64)])
def test_decode_partials_kernel_matches_plain(kv_dtype, hq, hkv, d):
    """At hymba-1.5b's shape, llama3-8b's, whisper-tiny's (Hq = Hkv = 6,
    D = 64), and the D = 128 shapes of qwen2-moe-a2.7b (one query head
    per KV head: the f32 cache asks for ~131 KB of shared memory a block),
    dbrx-132b (Hq 48, Hkv 8) and llava-next-34b (Hq 56, Hkv 8):
    rtol 1e-4 / atol 1e-5 against the plain version computed in
    float64 (the exact value that float32 sums in any order round: the
    row with no live key sums all 2,048 value rows, and two float32
    orders of that sum differ by more than 1e-5), two runs bitwise equal;
    rows with lo = 0, lo > 0 (a sliding window), a one-key range, no live
    key, ranges that start and end on the kernel's 128-key split
    boundaries and inside them, and hi = S.  Every live row has NaN and
    Inf in its dead keys and values (before lo, past hi): the kernel never
    reads them."""
    from repro_torch.kernels.flash_decode import decode_partials
    from repro_torch.kernels.flash_decode.ref import decode_partials_ref

    dev = require_cuda()
    s = 2048
    ranges = [(0, 1041), (17, 1041), (1040, 1041), (5, 5), (128, 256),
              (0, s), (1000, 1100), (127, 129), (1984, s), (64, 128)]
    b = len(ranges)
    rng = np.random.default_rng(hq * d)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(
        np.float32)).to(dev)
    kv = [rng.standard_normal((b, s, hkv, d)).astype(np.float32)
          for _ in range(2)]
    for r, (a, z) in enumerate(ranges):
        if a < z:
            for x, bad in zip(kv, (np.nan, np.inf)):
                x[r, :a], x[r, z:, :, ::2] = bad, -np.inf
                x[r, z:, :, 1::2] = np.nan
    k, v = (torch.from_numpy(x).to(dev, kv_dtype) for x in kv)
    lo = torch.tensor([r[0] for r in ranges], dtype=torch.int32, device=dev)
    hi = torch.tensor([r[1] for r in ranges], dtype=torch.int32, device=dev)
    before = dispatch.launch_counts().get("decode_partials", 0)
    got = decode_partials(q, k, v, lo, hi, use_kernel=True)
    again = decode_partials(q, k, v, lo, hi, use_kernel=True)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["decode_partials"] == before + 2
    want = decode_partials_ref(q, k, v, lo, hi, dtype=torch.float64)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w.float(), rtol=1e-4, atol=1e-5)
        assert bool(torch.isfinite(g).all())
    assert bool((got[1][3] == s).all())          # the empty row: l = S


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "minicpm3-4b"])
def test_moe_and_mla_serving_on_card(arch):
    """Reduced qwen2-moe-a2.7b and minicpm3-4b on the card: the kernel
    route equals the plain route (logits within 1e-4, the same tokens
    teacher-forced into both); qwen2-moe decodes through
    ``decode_partials`` once per layer and token, minicpm3's absorbed
    decode through no kernel; the card's logits equal a CPU engine's on
    the same weights within 1e-4; the MoE layer twice on the card is
    bitwise equal (no float atomics in its combine)."""
    from repro_torch.configs import reduced
    from repro_torch.models import init_params
    from repro_torch.models import layers as TL
    from repro_torch.serve.engine import ServingEngine

    dev = require_cuda()
    cfg = reduced(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    engines = [ServingEngine(cfg, params, max_len=64, dtype=torch.float32,
                             device=dev, use_kernel=uk)
               for uk in (None, False)]
    engines.append(ServingEngine(cfg, params, max_len=64,
                                 dtype=torch.float32, device="cpu"))
    dispatch.reset_launch_counts()
    tokens = engines[0].generate_greedy({"tokens": prompt}, 6)
    counts = dispatch.launch_counts()
    want = cfg.n_layers * 6 if cfg.attn_type == "gqa" else 0
    assert counts.get("decode_partials", 0) == want
    logits = [[e.prefill({"tokens": prompt})] for e in engines]
    for i in range(tokens.shape[1]):
        for e, out in zip(engines, logits):
            out.append(e.decode(tokens[:, i:i + 1]))
    for a, b, c in zip(*logits):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-4)
    if cfg.moe is not None:
        lp = params["layers"][0]["moe"]
        x = torch.randn((8, 128, cfg.d_model), device=dev)
        assert torch.equal(TL.moe_forward(lp, x, cfg),
                           TL.moe_forward(lp, x, cfg))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-tiny",
                                  "rwkv6-7b"])
def test_vlm_audio_rwkv_serving_on_card(arch):
    """Reduced llava-next-34b (patch prefix), whisper-tiny (encoder,
    cross-attention) and rwkv6-7b (the WKV loop) on the card: the kernel
    route equals the plain route and a CPU engine on the same weights and
    inputs (logits within 1e-4, the same tokens teacher-forced into
    each); llava and whisper decode through ``decode_partials`` once per
    decoder layer and token, rwkv through no kernel."""
    from repro_torch.configs import reduced
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServingEngine

    dev = require_cuda()
    cfg = reduced(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (3, 40)).astype(
        np.int32)}
    if cfg.vlm is not None:
        batch["patches"] = rng.standard_normal(
            (3, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encdec is not None:
        batch["frames"] = rng.standard_normal(
            (3, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    engines = [ServingEngine(cfg, params, max_len=64, dtype=torch.float32,
                             device=dev, use_kernel=uk)
               for uk in (None, False)]
    engines.append(ServingEngine(cfg, params, max_len=64,
                                 dtype=torch.float32, device="cpu"))
    dispatch.reset_launch_counts()
    tokens = engines[0].generate_greedy(batch, 6)
    counts = dispatch.launch_counts()
    want = 0 if cfg.family == "ssm" else cfg.n_layers * 6
    assert counts.get("decode_partials", 0) == want
    logits = [[e.prefill(batch)] for e in engines]
    for i in range(tokens.shape[1]):
        for e, out in zip(engines, logits):
            out.append(e.decode(tokens[:, i:i + 1]))
    for a, b, c in zip(*logits):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_model_serving_kernels_match_plain():
    """A 4-layer reduced hymba (one sliding-window layer) served on the
    card through the kernels and through the plain versions, the same
    tokens teacher-forced into both: logits within 1e-4."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServingEngine

    dev = require_cuda()
    cfg = dataclasses.replace(reduced("hymba-1.5b"), n_layers=4)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (3, 300)).astype(np.int32)
    engines = [ServingEngine(cfg, params, max_len=320, dtype=torch.float32,
                             device=dev, use_kernel=uk)
               for uk in (None, False)]
    dispatch.reset_launch_counts()
    tokens = engines[0].generate_greedy({"tokens": prompt}, 8)
    counts = dispatch.launch_counts()
    assert counts["linear_scan"] == 4 and counts["decode_partials"] == 32
    logits = [[e.prefill({"tokens": prompt})] for e in engines]
    for i in range(tokens.shape[1]):
        for e, out in zip(engines, logits):
            out.append(e.decode(tokens[:, i:i + 1]))
    for a, b in zip(*logits):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        np.stack([np.argmax(x, -1) for x in logits[0][:-1]], 1), tokens)


@pytest.mark.gpu
@pytest.mark.parametrize("use_preagg", [False, True],
                         ids=["fused", "preagg"])
def test_sharded_engine_equals_unsharded_on_card(use_preagg):
    """A sharded, replicated engine on the card serves the unsharded
    engine's bytes (after a rebalance and a kill + heal too), and a
    fused batch launches as many unit-fold and hash kernels as the
    unsharded batch of the same size."""
    dev = require_cuda()
    sql = SMOKE_SQL
    opts = dict(fused_fold=True)
    if use_preagg:
        sql = SMOKE_SQL + 'OPTIONS (long_windows = "w:10s")'
        opts = dict(use_preagg=True)
    tables = make_action_tables(n_actions=600, n_orders=300, n_users=12,
                                horizon_ms=600_000, zipf_alpha=1.2, seed=3,
                                with_profile=False)
    engines = [FeatureEngine(sql, tables, capacity=2048, device=dev,
                             **opts),
               FeatureEngine(sql, tables, capacity=2048, n_shards=8,
                             replication=2, ship_every=32, device=dev,
                             **opts)]
    for name in ("orders", "actions"):
        rows = [tables[name].row(i) for i in range(len(tables[name]) - 80)]
        for e in engines:
            e.ingest_many(name, rows)
    probe = [dict(tables["actions"].row(530 + i)) for i in range(64)]
    counts = []
    outs = []
    for e in engines:
        dispatch.reset_launch_counts()
        outs.append(e.request_batch(probe))
        counts.append(dispatch.launch_counts())
    if not use_preagg:
        assert counts[0] == counts[1]
        assert counts[1]["unit_fold"] == 2 and counts[1]["feature_hash"] == 1
    sharded = engines[1]
    assert sharded.rebalance()
    sharded.kill_shard(int(sharded.store.owner_of_keys(
        [probe[0]["userid"]])[0]))
    sharded.heal()
    outs.append(sharded.request_batch(probe))
    for got in outs[1:]:
        for g, w in zip(got, outs[0]):
            for k in w:
                if k.startswith("ew"):
                    np.testing.assert_allclose(g[k], w[k], rtol=EW_RTOL,
                                               atol=EW_ATOL)
                else:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_offline_sharded_equals_offline_on_card(n_shards):
    """``offline_sharded`` on the card, bitwise ``offline()`` for every
    shard count, each unit class one unit-fold launch as there."""
    dev = require_cuda()
    tables = make_action_tables(n_actions=3000, n_orders=1000, n_users=16,
                                horizon_ms=600_000, zipf_alpha=1.3, seed=4,
                                with_profile=False)
    cs = compile_script(SMOKE_SQL, tables=tables, offline_slice_rows=256)
    dispatch.reset_launch_counts()
    want = cs.offline(tables, device=dev)
    n_plain = dispatch.launch_counts()["unit_fold"]
    dispatch.reset_launch_counts()
    got = cs.offline_sharded(tables, n_shards=n_shards, device=dev)
    assert dispatch.launch_counts()["unit_fold"] == n_plain
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _same_features(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("ew"):
            np.testing.assert_allclose(got[k], want[k], rtol=EW_RTOL,
                                       atol=EW_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.gpu
def test_preview_and_pipeline_on_card_equal_cpu():
    """Preview and the training-data pipeline on the card equal the
    port on the CPU (bitwise, EW at its bar), launch the unit-fold and
    hash kernels, and yield batches on the card."""
    from repro_torch.core.preview import PreviewLimits, preview
    from repro_torch.data import FeatureDataPipeline

    dev = require_cuda()
    tables = make_action_tables(n_actions=3000, n_orders=1000, n_users=16,
                                horizon_ms=600_000, seed=5,
                                with_profile=False)
    limits = PreviewLimits(max_rows_per_table=500)
    dispatch.reset_launch_counts()
    got = preview(SMOKE_SQL, tables, limits=limits, use_cache=False,
                  device=dev)
    counts = dispatch.launch_counts()
    assert counts["unit_fold"] >= 1 and counts["feature_hash"] == 1
    want = preview(SMOKE_SQL, tables, limits=limits, use_cache=False,
                   device="cpu")
    assert (got.n_rows, got.truncated) == (want.n_rows, want.truncated)
    _same_features(got.features, want.features)
    cs = compile_script(SMOKE_SQL, tables=tables)
    pipes = [FeatureDataPipeline(cs, tables, batch_size=64, seed=1,
                                 device=d) for d in (dev, "cpu")]
    _same_features(pipes[0].materialize(), pipes[1].materialize())
    # every SMOKE_SQL feature is one column of the matrix
    ew = np.asarray([n.startswith("ew") for n in cs.feature_names])
    for g, w in zip(pipes[0].batches(3), pipes[1].batches(3)):
        assert g["features"].device.type == "cuda"
        assert g["labels"].dtype == torch.int32
        a, b = g["features"].cpu().numpy(), w["features"].numpy()
        np.testing.assert_array_equal(a[:, ~ew], b[:, ~ew])
        np.testing.assert_allclose(a[:, ew], b[:, ew], rtol=EW_RTOL,
                                   atol=EW_ATOL)
        np.testing.assert_array_equal(g["labels"].cpu().numpy(),
                                      w["labels"].numpy())


@pytest.mark.gpu
def test_memory_bound_equals_card_store_nbytes():
    """The certifier's store and plane bytes equal the tensors a card
    engine holds."""
    from repro_torch.core.analysis import memory_bound

    dev = require_cuda()
    tables = make_action_tables(n_actions=600, n_orders=300, n_users=12,
                                horizon_ms=600_000, seed=3,
                                with_profile=False)
    sql = SMOKE_SQL + 'OPTIONS (long_windows = "w:10s")'
    eng = FeatureEngine(sql, tables, capacity=4096, use_preagg=True,
                        device=dev)
    store = sum(t.nbytes for st in eng.store.tables.values()
                for t in (st["keys"], st["ts"], st["count"], st["comp"],
                          *st["cols"].values()))
    planes = sum(w.preagg.plane_bytes(eng.pre_states[wi])
                 for wi, w in enumerate(eng.cs.windows)
                 if w.preagg is not None)
    m = memory_bound(eng.cs, capacity=4096)
    assert (m["store_bytes"], m["preagg_bytes"]) == (store, planes)
    assert all(t.device.type == "cuda" for st in eng.store.tables.values()
               for t in (st["keys"], st["comp"]))


@pytest.mark.gpu
@pytest.mark.parametrize("use_preagg", [False, True],
                         ids=["fused", "preagg"])
def test_mesh_engine_on_one_card_equals_stacked(use_preagg):
    """A mesh of four entries naming the card (one shard's state each)
    serves, materializes offline and heals bitwise as the stacked
    ``n_shards=4`` engine on the card; every shard's tensors lie on the
    card, and a batch launches the fold and hash kernels once per shard
    that holds a request."""
    from repro_torch.distributed.sharding import Mesh

    dev = require_cuda()
    sql = SMOKE_SQL
    opts = dict(fused_fold=True)
    if use_preagg:
        sql = SMOKE_SQL + 'OPTIONS (long_windows = "w:10s")'
        opts = dict(use_preagg=True)
    tables = make_action_tables(n_actions=600, n_orders=300, n_users=12,
                                horizon_ms=600_000, zipf_alpha=1.2, seed=3,
                                with_profile=False)
    mesh = Mesh([dev] * 4, ("shard",))
    engines = [FeatureEngine(sql, tables, capacity=2048, n_shards=4,
                             replication=1, device=dev, **opts),
               FeatureEngine(sql, tables, capacity=2048, mesh=mesh,
                             replication=1, **opts)]
    for name in ("orders", "actions"):
        rows = [tables[name].row(i) for i in range(len(tables[name]) - 80)]
        for e in engines:
            e.ingest_many(name, rows)
    probe = [dict(tables["actions"].row(530 + i)) for i in range(64)]
    outs, counts = [], []
    for e in engines:
        dispatch.reset_launch_counts()
        outs.append(e.request_batch(probe))
        counts.append(dispatch.launch_counts())
    owners = len(set(engines[1].store.owner_of_keys(
        [r["userid"] for r in probe]).tolist()))
    assert counts[1]["feature_hash"] == owners * counts[0]["feature_hash"]
    meshed = engines[1]
    assert all(t.device.type == "cuda" for parts in meshed.store.tables
               .values() for st in parts for t in (st["keys"], st["comp"]))
    meshed.kill_shard(int(meshed.store.owner_of_keys(
        [probe[0]["userid"]])[0]))
    meshed.heal()
    outs.append(meshed.request_batch(probe))
    for got in outs[1:]:
        for g, w in zip(got, outs[0]):
            _same_features(g, w)
    off = [e.offline() for e in engines]
    for k in off[0]:
        np.testing.assert_array_equal(off[1][k], off[0][k], err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "hymba-1.5b"])
def test_sequence_sharded_decode_kernel_matches_plain_on_card(arch):
    """Reduced models in float32 on the card, a (1, 4) mesh of the card:
    the sequence-sharded decode through the ``decode_partials`` kernel
    (four launches a layer) equals the same decode through the plain
    version and the unsharded decode, within 2e-4."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.models import model as TM

    dev = require_cuda()
    cfg = dataclasses.replace(reduced(arch), n_layers=4)
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))
                              .astype(np.int32)).to(dev)
    steps = rng.integers(0, cfg.vocab_size, (6, 2, 1)).astype(np.int32)
    mesh = Mesh(np.array([[dev] * 4], dtype=object), ("data", "model"))

    def run(mesh, use_kernel):
        _, state = TM.forward_prefill(cfg, params, {"tokens": prompt},
                                      cache_capacity=64,
                                      use_kernel=use_kernel)
        out = []
        dispatch.reset_launch_counts()
        with runtime.use_mesh(mesh):
            for t in steps:
                logits, state = TM.decode_step(
                    cfg, params, state, torch.from_numpy(t).to(dev),
                    use_kernel=use_kernel)
                out.append(logits.cpu().numpy())
        return np.stack(out), dispatch.launch_counts().get(
            "decode_partials", 0)

    got, n = run(mesh, None)
    assert n == 4 * cfg.n_layers * len(steps)
    plain, n_plain = run(mesh, False)
    assert n_plain == 0
    unsharded, n_one = run(None, None)
    assert n_one == cfg.n_layers * len(steps)
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, unsharded, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "hymba-1.5b"])
def test_pieces_decode_on_distinct_cards(arch):
    """Reduced models in float32, the decode state in pieces over a
    (1, n) mesh of n distinct cards, 4 where four are visible, else 2
    (counts the cache's 64 positions divide by; ``device_put``: each
    piece on its entry's card): one ``decode_partials`` launch per entry,
    layer and step, each on its own card; logits within 2e-4 of the
    unsharded decode on the first card; layer 0's gathered K/V (which
    depend on the tokens only) bitwise the unsharded decode's.  Skipped
    where fewer than two cards are visible (``chip_smoke.py`` phase 4m
    (d) says the same)."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import (Mesh, Placed,
                                                  cache_pspecs, device_put,
                                                  gather, named_shardings)
    from repro_torch.models import model as TM
    from repro_torch.models.sharded_decode import decode_cache_spec

    require_cuda()
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"needs two visible CUDA devices, {count} visible")
    n = 4 if count >= 4 else 2
    cards = [torch.device("cuda", i) for i in range(n)]
    home = cards[0]
    cfg = dataclasses.replace(reduced(arch), n_layers=4)
    params = TM.init_params(cfg, torch.Generator(device=home).manual_seed(0),
                            dtype=torch.float32, device=home)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))
                              .astype(np.int32)).to(home)
    steps = rng.integers(0, cfg.vocab_size, (6, 2, 1)).astype(np.int32)
    mesh = Mesh(np.array([cards], dtype=object), ("data", "model"))

    def run(on_mesh):
        _, state = TM.forward_prefill(cfg, params, {"tokens": prompt},
                                      cache_capacity=64)
        if on_mesh:
            specs = cache_pspecs(cfg, state, mesh)
            for lc in specs["layers"]:
                lc["attn"] = {k: decode_cache_spec(2, mesh)
                              for k in ("k", "v")}
            state = device_put(state, named_shardings(specs, mesh))
        out = []
        dispatch.reset_launch_counts()
        with runtime.use_mesh(mesh if on_mesh else None):
            for t in steps:
                logits, state = TM.decode_step(
                    cfg, params, state, torch.from_numpy(t).to(home))
                out.append(logits.cpu().numpy())
        return np.stack(out), state, dispatch.launch_counts().get(
            "decode_partials", 0)

    got, state, launches = run(True)
    assert launches == n * cfg.n_layers * len(steps)
    k0 = state["layers"][0]["attn"]["k"]
    assert isinstance(k0, Placed)
    assert [p.device for p in k0.pieces.flat] == cards
    one, one_state, _ = run(False)
    np.testing.assert_allclose(got, one, rtol=2e-4, atol=2e-4)
    for name in ("k", "v"):
        assert torch.equal(gather(state["layers"][0]["attn"][name], home),
                           one_state["layers"][0]["attn"][name])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_mla_latent_pieces_on_card(shape):
    """Reduced minicpm3-4b in float32 on the card, B = 4, a latent of
    4,096 positions drawn from a seed and placed by ``cache_pspecs`` on
    a mesh of the card's entries (rows live to 5 / 1,030 / 2,500 /
    4,000): 4 greedy steps on the pieces within 1e-5 of the whole-latent
    decode, the latent still ``Placed`` after every step, no kernel
    launched (the absorbed decode is plain torch)."""
    from repro_torch.configs import reduced
    from repro_torch.distributed import runtime
    from repro_torch.distributed.sharding import (Mesh, Placed,
                                                  cache_pspecs, device_put,
                                                  named_shardings)
    from repro_torch.models import model as TM

    dev = require_cuda()
    cfg = reduced("minicpm3-4b")
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.float32, device=dev)
    b, s = 4, 4096
    width = cfg.mla.kv_rank + cfg.mla.rope_dim
    gen = torch.Generator(device=dev).manual_seed(1)
    latent = [torch.randn((b, s, width), generator=gen, device=dev)
              for _ in range(cfg.n_layers)]
    mesh = Mesh(np.full(shape, dev, dtype=object), ("data", "model"))

    def state():
        return {"len": torch.tensor([5, 1030, 2500, 4000], dtype=torch.int32,
                                    device=dev),
                "layers": [{"attn": {"latent": t.clone()}} for t in latent]}

    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, 1)).astype(np.int32)).to(dev)
    whole, st, toks = [], state(), []
    for _ in range(4):
        toks.append(tok)
        logits, st = TM.decode_step(cfg, params, st, tok)
        whole.append(logits.cpu().numpy())
        tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(
            torch.int32)
    st = state()
    st = device_put(st, named_shardings(cache_pspecs(cfg, st, mesh), mesh))
    got = []
    dispatch.reset_launch_counts()
    with runtime.use_mesh(mesh):
        for t in toks:
            logits, st = TM.decode_step(cfg, params, st, t)
            got.append(logits.cpu().numpy())
            assert all(isinstance(lc["attn"]["latent"], Placed)
                       for lc in st["layers"])
    assert not any(dispatch.launch_counts().values())
    np.testing.assert_allclose(np.stack(got), np.stack(whole), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_hymba_state_pieces_on_card(shape):
    """``chip_smoke.py`` phase 4t (a)'s hymba check at reduced size on the
    card, float32: 3 layers (a window layer between two global ones), B
    = 4 prompts of 300 tokens prefilled into 4,096 positions (the scan
    kernel), rows then live to 5 / 1,030 / 2,500 / 4,000; the state
    placed by ``cache_pspecs`` on a mesh of the card's entries (the SSM
    state in channel pieces, K/V in sequence pieces): 4 greedy steps
    within 1e-5 of the whole state, every leaf in its layout after every
    step, one ``decode_partials`` per entry, layer and step, no byte of
    SSM state or K/V gathered."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed import runtime
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.fault import tree_flatten
    from repro_torch.distributed.sharding import (Mesh, Placed,
                                                  cache_pspecs, device_put,
                                                  named_shardings)
    from repro_torch.models import model as TM

    dev = require_cuda()
    cfg = dataclasses.replace(reduced("hymba-1.5b"), n_layers=3)
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.float32, device=dev)
    b, lens = 4, [5, 1030, 2500, 4000]
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 300))
                              .astype(np.int32)).to(dev)
    dispatch.reset_launch_counts()
    _, state0 = TM.forward_prefill(cfg, params, {"tokens": prompt},
                                   cache_capacity=4096)
    assert dispatch.launch_counts().get("linear_scan") == cfg.n_layers
    state0["len"] = torch.tensor(lens, dtype=torch.int32, device=dev)
    mesh = Mesh(np.full(shape, dev, dtype=object), ("data", "model"))
    shardings = named_shardings(cache_pspecs(cfg, state0, mesh), mesh)

    def clone(t):
        if isinstance(t, dict):
            return {k: clone(v) for k, v in t.items()}
        return [clone(v) for v in t] if isinstance(t, list) else t.clone()

    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1))
                           .astype(np.int32)).to(dev)
    whole, st, toks = [], clone(state0), []
    for _ in range(4):
        toks.append(tok)
        logits, st = TM.decode_step(cfg, params, st, tok)
        whole.append(logits.cpu().numpy())
        tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(
            torch.int32)
    st = device_put(state0, shardings)
    seen, got = [], []
    real = SH._whole
    SH._whole = lambda x, d: seen.append(tuple(x.shape)) or real(x, d)
    dispatch.reset_launch_counts()
    try:
        with runtime.use_mesh(mesh):
            for t in toks:
                logits, st = TM.decode_step(cfg, params, st, t)
                got.append(logits.cpu().numpy())
                for x, sh in zip(tree_flatten(st)[0],
                                 tree_flatten(shardings)[0]):
                    assert isinstance(x, Placed)
                    assert SH._same_layout(x, sh)
    finally:
        SH._whole = real
    assert dispatch.launch_counts() == {
        "decode_partials": 4 * cfg.n_layers * mesh.devices.size}
    assert set(seen) == {(b,)}
    np.testing.assert_allclose(np.stack(got), np.stack(whole), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_counted_step_records_one_cost_per_launch(kind):
    """``roofline.analyze_step`` over a step on the card: each kernel's
    cost records equal its launches in that step, and the FLOPs equal
    the same step counted on ``meta``."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed.fault import tree_map
    from repro_torch.models import (decode_step, forward_prefill,
                                    init_decode_state, init_params)
    from repro_torch.roofline import analyze_step
    from repro_torch.train import AdamWConfig, adamw_init, build_train_step

    dev = require_cuda()
    cfg = dataclasses.replace(reduced("hymba-1.5b"), n_layers=4)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), dtype=torch.int32,
                           device=dev)

    def meta(tree):
        return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)

    if kind == "prefill":
        def step(p, t):
            return forward_prefill(cfg, p, {"tokens": t}, cache_capacity=64)
        args = (params, tokens)
    elif kind == "decode":
        state = init_decode_state(cfg, 2, 64, dtype=torch.float32,
                                  device=dev)
        state["len"].fill_(40)

        def step(p, st, t):
            return decode_step(cfg, p, st, t)
        args = (params, state, tokens[:, :1])
    else:
        train = build_train_step(cfg, AdamWConfig(), n_micro=2,
                                 compute_dtype=torch.float32)

        def step(st, t):
            return train(st, {"tokens": t})
        args = (adamw_init(params), tokens)
    dispatch.reset_launch_counts()
    cost = analyze_step(step, *args)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    assert {k: v["calls"] for k, v in cost.kernels.items()} == launches
    assert launches
    assert analyze_step(step, *meta(args)).flops == cost.flops


def _pieces_on(arch, cards):
    """Reduced ``arch`` (8 heads, 4 KV heads, 3 layers) in float32, its
    params placed by ``param_pspecs(strategy="megatron")`` on a (1, 4)
    mesh over ``cards``: greedy tokens through the pieces and the
    kernels (one ``decode_partials`` launch per entry, layer and step,
    the cache in KV-head pieces on the cards), then the teacher-forced
    logits against the unsharded model and the pieces through the plain
    versions, within 2e-4 (``chip_smoke.py`` phase 4o at full width)."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed.sharding import (Mesh, Placed, device_put,
                                                  named_shardings,
                                                  param_pspecs)
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServingEngine

    home = cards[0]
    cfg = dataclasses.replace(reduced(arch), n_heads=8, n_kv_heads=4,
                              n_layers=3)
    params = init_params(cfg, torch.Generator(device=home).manual_seed(0),
                         dtype=torch.float32, device=home)
    mesh = Mesh(np.array([cards], dtype=object), ("data", "model"))
    placed = device_put(params, named_shardings(
        param_pspecs(cfg, params, mesh, strategy="megatron"), mesh))
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    n_tok = 4

    def forced(eng, tokens):
        out = [eng.prefill({"tokens": prompt})]
        for i in range(n_tok):
            out.append(eng.decode(tokens[:, i:i + 1]))
        return np.stack(out)

    eng = ServingEngine(cfg, placed, max_len=32, dtype=torch.float32)
    dispatch.reset_launch_counts()
    tokens = eng.generate_greedy({"tokens": prompt}, n_tok)
    torch.cuda.synchronize()
    assert dispatch.launch_counts() == {
        "decode_partials": 4 * cfg.n_layers * n_tok}
    k0 = eng.state["layers"][0]["attn"]["k"]
    assert isinstance(k0, Placed)
    assert [t.device for t in k0.pieces.flat] == list(cards)
    got = forced(eng, tokens)
    plain = forced(ServingEngine(cfg, placed, max_len=32,
                                 dtype=torch.float32, use_kernel=False),
                   tokens)
    one = forced(ServingEngine(cfg, params, max_len=32, dtype=torch.float32,
                               device=home), tokens)
    np.testing.assert_allclose(got, one, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "dbrx-132b"])
def test_weights_in_pieces_on_entries_of_the_card(arch):
    dev = require_cuda()
    _pieces_on(arch, [torch.device("cuda", dev.index or 0)] * 4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "dbrx-132b"])
def test_weights_in_pieces_on_four_cards(arch):
    """Skipped where fewer than four cards are visible (``chip_smoke.py``
    phase 4o (b) says the same)."""
    require_cuda()
    count = torch.cuda.device_count()
    if count < 4:
        pytest.skip(f"needs four visible CUDA devices, {count} visible")
    _pieces_on(arch, [torch.device("cuda", i) for i in range(4)])


def _train_pieces_on(arch, cards):
    """Reduced ``arch`` (8 heads, 4 KV heads, 2 layers) in float32: the
    reference's train cell on a (1, 4) mesh over ``cards``
    (``TrainState(step=P(), params=p_specs, mu=p_specs, nu=p_specs,
    compress_err=P())``, ``param_pspecs(strategy="megatron")``, placed by
    ``device_put``), one ``build_train_step(..., dp_axes=("data",),
    mesh=...)`` step in two microbatches against the whole tree's step on
    the home card: loss and grad norm at rtol 1e-4, params at
    ``tests/test_torch_train.py``'s bars (``chip_smoke.py`` phase 4p
    (a)'s); the gradients on the pieces' cards; the same step from
    another copy of the state bitwise equal; hymba's SSM through the scan
    kernels (2 forward and 1 backward launch per layer and
    microbatch)."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed.fault import tree_flatten, tree_map
    from repro_torch.distributed.sharding import (Mesh, PartitionSpec,
                                                  Placed, device_put, gather,
                                                  named_shardings,
                                                  param_pspecs)
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                                   build_train_step)
    from repro_torch.train.steps import loss_and_grads

    home = cards[0]
    cfg = dataclasses.replace(reduced(arch), n_heads=8, n_kv_heads=4,
                              n_layers=2)
    mesh = Mesh(np.array([cards], dtype=object), ("data", "model"))
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 40)).astype(np.int32)).to(home)
    batch = {"tokens": tokens}

    def fresh():
        return adamw_init(init_params(
            cfg, torch.Generator(device=home).manual_seed(0),
            dtype=torch.float32, device=home))

    whole = fresh()
    p_specs = param_pspecs(cfg, whole.params, mesh, strategy="megatron")
    specs = TrainState(step=PartitionSpec(), params=p_specs, mu=p_specs,
                       nu=p_specs, compress_err=tree_map(
                           lambda _: PartitionSpec(), whole.params))
    shardings = named_shardings(specs, mesh)
    placed = device_put(whole, shardings)
    _, grads = loss_and_grads(cfg, placed.params, batch, 2, torch.float32,
                              dp_axes=("data",))
    for g, p in zip(tree_flatten(grads)[0],
                    tree_flatten(placed.params)[0]):
        assert [t.device for t in g.pieces.flat] == \
            [t.device for t in p.pieces.flat]
    del grads
    step = build_train_step(cfg, opt, n_micro=2, compute_dtype=torch.float32,
                            dp_axes=("data",), mesh=mesh)
    dispatch.reset_launch_counts()
    new, m = step(placed, batch)
    torch.cuda.synchronize()
    if cfg.ssm is not None:
        assert dispatch.launch_counts() == {
            "linear_scan": 2 * 2 * cfg.n_layers,
            "linear_scan_bwd": 2 * cfg.n_layers}
    twin, m2 = step(device_put(fresh(), shardings), batch)
    assert torch.equal(m["loss"], m2["loss"])
    for a, b in zip(tree_flatten(new.params)[0],
                    tree_flatten(twin.params)[0]):
        assert isinstance(a, Placed)
        for i in np.ndindex(a.pieces.shape):
            assert torch.equal(a.pieces[i], b.pieces[i])
    one, om = build_train_step(cfg, opt, n_micro=2,
                               compute_dtype=torch.float32)(whole, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(om[k]), rtol=1e-4)
    for g, w in zip(tree_flatten(new.params)[0],
                    tree_flatten(one.params)[0]):
        g, w = gather(g, "cpu").numpy(), w.cpu().numpy()
        miss = ~np.isclose(g, w, rtol=1e-4, atol=1e-6)
        if miss.any():
            assert np.abs(g - w)[miss].max() <= 2 * opt.lr
            assert miss.mean() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "hymba-1.5b"])
def test_train_on_pieces_on_entries_of_the_card(arch):
    dev = require_cuda()
    _train_pieces_on(arch, [torch.device("cuda", dev.index or 0)] * 4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "hymba-1.5b"])
def test_train_on_pieces_on_four_cards(arch):
    """Skipped where fewer than four cards are visible (``chip_smoke.py``
    phase 4p (b) says the same)."""
    require_cuda()
    count = torch.cuda.device_count()
    if count < 4:
        pytest.skip(f"needs four visible CUDA devices, {count} visible")
    _train_pieces_on(arch, [torch.device("cuda", i) for i in range(4)])


def _moe_dp_on(cards):
    """Reduced qwen2-moe-a2.7b (4 experts, top-2, 2 layers) in float32,
    B = 8 x 32 in 2 microbatches, on the card: the whole tree's DP step
    with one data block per card of ``cards`` (a (4, 1) mesh), and the
    reference's train cell placed by ``param_pspecs(strategy=
    "megatron")`` on a (2, 2) mesh over them, one data block per mesh
    row, each against the one-device step on the home card: loss and
    grad norm at rtol 1e-4, params at ``tests/test_torch_train.py``'s
    bars (``chip_smoke.py`` phase 4q (a) at full width)."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed.fault import tree_flatten, tree_map
    from repro_torch.distributed.sharding import (Mesh, PartitionSpec,
                                                  device_put, gather,
                                                  named_shardings,
                                                  param_pspecs)
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                                   build_train_step)

    home = cards[0]
    cfg = dataclasses.replace(reduced("qwen2-moe-a2.7b"), n_layers=2)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)).to(home)}

    def fresh():
        return adamw_init(init_params(
            cfg, torch.Generator(device=home).manual_seed(0),
            dtype=torch.float32, device=home))

    def run(state, **kw):
        return build_train_step(cfg, opt, n_micro=2,
                                compute_dtype=torch.float32, **kw)(
            state, batch)

    one, om = run(fresh())
    rows = Mesh(np.array([[c] for c in cards], dtype=object),
                ("data", "model"))
    grid = Mesh(np.array(cards, dtype=object).reshape(2, 2),
                ("data", "model"))
    whole = fresh()
    p_specs = param_pspecs(cfg, whole.params, grid, strategy="megatron")
    specs = TrainState(step=PartitionSpec(), params=p_specs, mu=p_specs,
                       nu=p_specs, compress_err=tree_map(
                           lambda _: PartitionSpec(), whole.params))
    placed = device_put(whole, named_shardings(specs, grid))
    for new, m in (run(fresh(), dp_axes=("data",), mesh=rows),
                   run(placed, dp_axes=("data",), mesh=grid)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(om[k]),
                                       rtol=1e-4)
        for g, w in zip(tree_flatten(new.params)[0],
                        tree_flatten(one.params)[0]):
            g, w = gather(g, "cpu").numpy(), w.cpu().numpy()
            miss = ~np.isclose(g, w, rtol=1e-4, atol=1e-6)
            if miss.any():
                assert np.abs(g - w)[miss].max() <= 2 * opt.lr
                assert miss.mean() <= 1e-3


@pytest.mark.gpu
def test_moe_dp_step_on_entries_of_the_card():
    dev = require_cuda()
    _moe_dp_on([torch.device("cuda", dev.index or 0)] * 4)


@pytest.mark.gpu
def test_moe_dp_step_on_four_cards():
    """Skipped where fewer than four cards are visible (``chip_smoke.py``
    phase 4q (b) says the same)."""
    require_cuda()
    count = torch.cuda.device_count()
    if count < 4:
        pytest.skip(f"needs four visible CUDA devices, {count} visible")
    _moe_dp_on([torch.device("cuda", i) for i in range(4)])


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compression_on_pieces_on_the_card(scheme):
    """Seeded gradients and residuals of reduced llama3-8b (8 heads, 4 KV
    heads, 2 layers) on the card, whole and placed by
    ``param_pspecs(strategy="megatron")`` on (1, 4) entries of it:
    compressed gradients and residuals of the pieces bitwise the whole
    tree's, the replicas equal."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed.compression import (int8_compress,
                                                     topk_compress)
    from repro_torch.distributed.fault import tree_flatten, tree_map
    from repro_torch.distributed.sharding import (Mesh, blocks, device_put,
                                                  gather, named_shardings,
                                                  param_pspecs)
    from repro_torch.models import init_params

    dev = require_cuda()
    cfg = dataclasses.replace(reduced("llama3-8b"), n_heads=8, n_kv_heads=4)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    mesh = Mesh(np.array([[dev] * 4], dtype=object), ("data", "model"))
    shardings = named_shardings(param_pspecs(cfg, params, mesh,
                                             strategy="megatron"), mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                           device=dev), params)
    err = tree_map(lambda p: 0.01 * torch.randn(p.shape, generator=gen,
                                                device=dev), params)
    fn = {"int8": int8_compress, "topk": topk_compress}[scheme]
    want = fn(grads, err)
    got = fn(device_put(grads, shardings), device_put(err, shardings))
    for w_tree, g_tree in zip(want, got):
        for w, g in zip(tree_flatten(w_tree)[0], tree_flatten(g_tree)[0]):
            assert torch.equal(gather(g, dev), w)
            for entries in blocks(g):
                for e in entries[1:]:
                    assert torch.equal(g.pieces[e], g.pieces[entries[0]])


@pytest.mark.gpu
def test_hymba_product_route_on_entries_of_the_card():
    """Reduced hymba-1.5b with 10 heads and 5 KV heads of 16 (d = 128, 2
    layers: the KV heads do not split four ways, ``Hkv * D`` does, as
    5 x 64 at full width) in float32, placed by ``param_pspecs(strategy=
    "megatron")`` on (1, 4) entries of the card: the product route, with
    the kernels, against the whole tree.  Greedy serving: logits within
    2e-4, ``decode_partials`` launched once a layer and step on all heads
    (the whole tree's count), the cache whole on the card; one train step
    in two microbatches: the scan launches equal the whole tree's, loss
    and grad norm at rtol 1e-4; only ``log_a`` gathered (``chip_smoke.py``
    phase 4r (a) at full width)."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed.fault import tree_map
    from repro_torch.distributed.sharding import (Mesh, PartitionSpec,
                                                  device_put,
                                                  named_shardings,
                                                  param_pspecs)
    from repro_torch.models import init_params
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                                   build_train_step)

    dev = require_cuda()
    home = torch.device("cuda", dev.index or 0)
    cfg = dataclasses.replace(reduced("hymba-1.5b"), d_model=128,
                              n_heads=10, n_kv_heads=5, head_dim=16,
                              n_layers=2)
    params = init_params(cfg, torch.Generator(device=home).manual_seed(0),
                         dtype=torch.float32, device=home)
    mesh = Mesh(np.array([[home] * 4], dtype=object), ("data", "model"))
    p_specs = param_pspecs(cfg, params, mesh, strategy="megatron")
    placed = device_put(params, named_shardings(p_specs, mesh))
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    gathered = []
    real = tp.gather

    def gathering(x, device):
        gathered.append(tuple(x.shape))
        return real(x, device)

    def serve(p):
        eng = ServingEngine(cfg, p, max_len=32, dtype=torch.float32,
                            device=home)
        dispatch.reset_launch_counts()
        tokens = eng.generate_greedy({"tokens": prompt}, 4)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        out = [eng.prefill({"tokens": prompt})]
        for i in range(4):
            out.append(eng.decode(tokens[:, i:i + 1]))
        return np.stack(out), counts, eng

    tp.gather = gathering
    try:
        got, counts, eng = serve(placed)
        assert isinstance(eng.state["layers"][0]["attn"]["k"], torch.Tensor)
        want, want_counts, _ = serve(params)
        assert counts == want_counts and counts["decode_partials"] == \
            cfg.n_layers * 4
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        log_a = tuple(params["layers"][0]["ssm"]["log_a"].shape)
        assert set(gathered) == {log_a}
        gathered.clear()
        opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
        batch = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (4, 40)).astype(np.int32)).to(home)}
        whole = adamw_init(params)
        specs = TrainState(step=PartitionSpec(), params=p_specs, mu=p_specs,
                           nu=p_specs, compress_err=tree_map(
                               lambda _: PartitionSpec(), whole.params))
        state = device_put(whole, named_shardings(specs, mesh))
        runs = {}
        for name, st, kw in (("pieces", state, dict(dp_axes=("data",),
                                                     mesh=mesh)),
                             ("whole", whole, {})):
            dispatch.reset_launch_counts()
            _, m = build_train_step(cfg, opt, n_micro=2,
                                    compute_dtype=torch.float32, **kw)(
                st, batch)
            torch.cuda.synchronize()
            runs[name] = (m, dispatch.launch_counts())
        assert runs["pieces"][1] == runs["whole"][1] == {
            "linear_scan": 2 * 2 * cfg.n_layers,
            "linear_scan_bwd": 2 * cfg.n_layers}
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(runs["pieces"][0][k]),
                                       float(runs["whole"][0][k]),
                                       rtol=1e-4)
        assert set(gathered) == {log_a}
    finally:
        tp.gather = real


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["cache_pspecs", "heads"])
def test_prefill_into_placed_state_on_every_card(route):
    """``chip_smoke.py`` phase 4u at reduced size: a (1, 4) mesh whose
    entries name every visible card in turn (four distinct cards where
    four are visible), reduced llama3-8b (8 heads, 4 KV heads) in
    float32, B = 4 prompts of 1,100 tokens into 4,096 positions.  The
    state placed empty by ``cache_pspecs`` (K/V in sequence pieces), or
    on megatron params the head route's KV-head pieces, is filled by
    ``forward_prefill(..., state=)``: logits and every leaf within 1e-5
    of the whole prefill on the first card, every piece on its entry's
    card, no byte of a placed leaf gathered; then 4 decode steps within
    1e-5 of the whole state's."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.distributed import runtime
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.fault import tree_flatten
    from repro_torch.distributed.sharding import (Mesh, Placed, cache_pspecs,
                                                  cuda_devices, device_put,
                                                  gather, named_shardings,
                                                  param_pspecs)
    from repro_torch.models import model as TM

    dev = require_cuda()
    cards = cuda_devices()
    mesh = Mesh(np.array([[cards[i % len(cards)] for i in range(4)]],
                         dtype=object), ("data", "model"))
    cfg = dataclasses.replace(reduced("llama3-8b"), n_heads=8,
                              n_kv_heads=4)
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.float32, device=dev)
    b, cap = 4, 4096
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, 1100)).astype(np.int32)).to(dev)}
    want, whole = TM.forward_prefill(cfg, params, batch, cache_capacity=cap)
    if route == "heads":
        p = device_put(params, named_shardings(param_pspecs(
            cfg, params, mesh, strategy="megatron"), mesh))
        state = TM.init_decode_state(cfg, b, cap, dtype=torch.float32,
                                     mesh=TM.kv_head_mesh(cfg, p))
        decode_mesh = None
    else:
        p, decode_mesh = params, mesh
        meta = TM.init_decode_state(cfg, b, cap, dtype=torch.float32,
                                    device="meta")
        state = device_put(meta, named_shardings(cache_pspecs(cfg, meta,
                                                              mesh), mesh))
    seen = []
    real = SH._whole
    SH._whole = lambda x, d: seen.append(tuple(x.shape)) or real(x, d)
    try:
        got, out = TM.forward_prefill(cfg, p, batch, cache_capacity=cap,
                                      state=state)
    finally:
        SH._whole = real
    assert not seen and out is state
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(tree_flatten(gather(out, dev))[0],
                    tree_flatten(whole)[0]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    k = out["layers"][0]["attn"]["k"]
    assert isinstance(k, Placed)
    assert [t.device for t in k.pieces.flat] == list(k.mesh.devices.flat)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)).astype(
        np.int32)).to(dev)
    for _ in range(4):
        lw, whole = TM.decode_step(cfg, params, whole, tok)
        with runtime.use_mesh(decode_mesh):
            lp, out = TM.decode_step(cfg, p, out, tok)
        np.testing.assert_allclose(lp.cpu().numpy(), lw.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
        tok = lw[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(
            torch.int32)
