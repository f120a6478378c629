"""Retention, port against reference: ``evict_before`` / ``OnlineStore.
evict``, the engine's retention lifecycle (``retention``, ``ttl_ms``,
``compact_every``, the binlog watermark, the memory guard's credit) and
the §8.1 memory model.  The store states after every tick are compared
bitwise, ``comp`` is checked against its definition, and the range seeks
after a compaction equal the reference's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.data.synthetic import make_action_tables as jax_tables
from repro.serve.engine import FeatureEngine as JaxEngine
from repro.storage import memest as jax_memest
from repro.storage import timestore as jax_ts
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.serve.engine import FeatureEngine as TorchEngine
from repro_torch.storage import memest as torch_memest
from repro_torch.storage import timestore as torch_ts

INT_MAX = 2**31 - 1

# the reference's tests/test_fold_engine.py RET_SQL
RET_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW)
"""

JOIN_SQL = """
SELECT sum(price) OVER w AS s, profile.age AS age
FROM actions
LAST JOIN profile ORDER BY ts ON actions.userid = profile.userid
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS BETWEEN 9 PRECEDING AND CURRENT ROW)
"""

UNION_SQL = """
SELECT sum(price) OVER w AS s, max(price) OVER w2 AS mx
FROM actions
WINDOW w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW),
  w2 AS (PARTITION BY userid ORDER BY ts
         ROWS_RANGE BETWEEN 20s PRECEDING AND CURRENT ROW)
"""

SUSTAINED = dict(n_actions=400, n_orders=0, n_users=4, horizon_ms=400_000,
                 seed=1, with_profile=False)


# ------------------------------------------------------------ evict_before


def _random_state(cap, n, seed, n_keys=5, t_lo=0, t_hi=1000, nan=False):
    """A store state of ``n`` live rows sorted by (key, ts), as numpy."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n).astype(np.int32)
    ts = rng.integers(t_lo, t_hi, n).astype(np.int32)
    order = np.lexsort((ts, keys))
    v = rng.normal(size=n).astype(np.float32)
    if nan and n:
        v[rng.integers(0, n, max(1, n // 5))] = np.nan
    code = rng.integers(0, 9, n).astype(np.int32)
    st = {"keys": np.full(cap, INT_MAX, np.int32),
          "ts": np.full(cap, INT_MAX, np.int32),
          "cols": {"v": np.zeros(cap, np.float32),
                   "code": np.zeros(cap, np.int32)},
          "count": np.int32(n)}
    st["keys"][:n], st["ts"][:n] = keys[order], ts[order]
    st["cols"]["v"][:n], st["cols"]["code"][:n] = v[order], code[order]
    return st


def _port_state(st):
    keys, ts = torch.from_numpy(st["keys"]), torch.from_numpy(st["ts"])
    return {"keys": keys, "ts": ts,
            "cols": {c: torch.from_numpy(v) for c, v in st["cols"].items()},
            "count": torch.tensor(int(st["count"]), dtype=torch.int32),
            "comp": torch_ts.composite(keys, ts)}


def _jax_state(st):
    return {"keys": jnp.asarray(st["keys"]), "ts": jnp.asarray(st["ts"]),
            "cols": {c: jnp.asarray(v) for c, v in st["cols"].items()},
            "count": jnp.asarray(st["count"], jnp.int32)}


def _assert_state(got, want):
    for k in ("keys", "ts", "count"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for c, v in want["cols"].items():
        g = got["cols"][c].numpy()
        assert g.dtype == np.asarray(v).dtype, c
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=c)
    np.testing.assert_array_equal(
        got["comp"].numpy(),
        torch_ts.composite(got["keys"], got["ts"]).numpy())


CASES = {
    "empty": dict(cap=16, n=0, horizon=5),
    "below-all": dict(cap=64, n=40, horizon=-10),
    "above-all": dict(cap=64, n=40, horizon=5000),
    "mid": dict(cap=64, n=50, horizon=500),
    "nan-values": dict(cap=64, n=50, horizon=300, nan=True),
    "full-capacity": dict(cap=48, n=48, horizon=700),
    "negative-ts": dict(cap=64, n=40, horizon=-200, t_lo=-1000, t_hi=1000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evict_before_matches_reference(case):
    kw = dict(CASES[case])
    cap, n, horizon = kw.pop("cap"), kw.pop("n"), kw.pop("horizon")
    st = _random_state(cap, n, seed=len(case), **kw)
    src = _port_state(st)
    before = {k: v.clone() for k, v in src.items() if k != "cols"}
    got = torch_ts.evict_before(src, horizon)
    want = jax_ts.evict_before(_jax_state(st), jnp.int32(horizon))
    _assert_state(got, want)
    # the input state is left as it was: a snapshot may still hold it
    for k, v in before.items():
        assert torch.equal(src[k], v), k


def test_evict_keeps_peers_at_the_horizon():
    """Rows AT the horizon are kept (``ts >= horizon``), in order."""
    st = _random_state(32, 24, seed=5, n_keys=3, t_lo=0, t_hi=6)
    got = torch_ts.evict_before(_port_state(st), 3)
    want = jax_ts.evict_before(_jax_state(st), jnp.int32(3))
    _assert_state(got, want)
    n = int(got["count"])
    assert n == int(np.sum(st["ts"][:24] >= 3)) and n > 0
    assert int(got["ts"][:n].min()) == 3


@pytest.mark.parametrize("horizon", [0, 400, 900])
def test_range_bounds_after_evict_match_reference(horizon):
    """The ``comp`` rebuild: seeks on the compacted state land where the
    reference's binary search does."""
    st = _random_state(128, 100, seed=11, n_keys=6)
    got = torch_ts.evict_before(_port_state(st), horizon)
    want = jax_ts.evict_before(_jax_state(st), jnp.int32(horizon))
    rng = np.random.default_rng(horizon)
    key = rng.integers(0, 7, 32).astype(np.int32)
    t0 = rng.integers(-50, 1000, 32).astype(np.int32)
    t1 = t0 + rng.integers(0, 400, 32).astype(np.int32)
    lo, hi = torch_ts.range_bounds(got, torch.from_numpy(key),
                                   torch.from_numpy(t0),
                                   torch.from_numpy(t1))
    for i in range(32):
        jlo, jhi = jax_ts.range_bounds(want, jnp.int32(key[i]),
                                       jnp.int32(t0[i]), jnp.int32(t1[i]))
        assert (int(lo[i]), int(hi[i])) == (int(jlo), int(jhi)), i


def test_store_evict_replaces_table_state():
    store = torch_ts.OnlineStore(capacity=32, device="cpu")
    store.create_table("t", {"v": np.float32})
    store.put_many("t", np.zeros(10, np.int32), np.arange(10, dtype=np.int32),
                   {"v": np.arange(10, dtype=np.float32)})
    snap = store.snapshot()
    old = store.tables["t"]
    store.evict("t", 6)
    assert store.n_rows("t") == 4 and snap.n_rows("t") == 10
    assert store.tables["t"] is not old
    np.testing.assert_array_equal(snap.tables["t"]["ts"][:10].numpy(),
                                  np.arange(10))
    np.testing.assert_array_equal(store.tables["t"]["cols"]["v"][:4].numpy(),
                                  [6, 7, 8, 9])


# ------------------------------------------------------ retention horizon


@pytest.mark.parametrize("sql, tables_kw, retention", [
    (RET_SQL, SUSTAINED, "auto"),
    (RET_SQL, SUSTAINED, 1000),        # a floor below the span: the span
    (RET_SQL, SUSTAINED, 12_000),      # a floor above it: the floor
    (RET_SQL, SUSTAINED, None),
    (JOIN_SQL, dict(n_actions=50, n_orders=0, n_users=4, seed=2), "auto"),
    (UNION_SQL, dict(n_actions=60, n_orders=40, n_users=4, seed=3,
                     with_profile=False), "auto"),
], ids=["auto", "floor-below", "floor-above", "off", "rows-join", "union"])
def test_retention_horizon_matches_reference(sql, tables_kw, retention):
    je = JaxEngine(sql, jax_tables(**tables_kw), capacity=64,
                   retention=retention)
    te = TorchEngine(sql, torch_tables(**tables_kw), capacity=64,
                     retention=retention, device="cpu")
    assert te.retention_ms == je.retention_ms
    if sql is JOIN_SQL:
        assert te.retention_ms == {"actions": None, "profile": None}


# ------------------------------------------------------ sustained ingest


def _store_equal(te, je):
    for t, st in je.store.tables.items():
        got = te.store.tables[t]
        for k in ("keys", "ts", "count"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(st[k]),
                                          err_msg=f"{t}/{k}")
        for c, v in st["cols"].items():
            np.testing.assert_array_equal(got["cols"][c].numpy(),
                                          np.asarray(v), err_msg=f"{t}/{c}")
        np.testing.assert_array_equal(
            got["comp"].numpy(),
            torch_ts.composite(got["keys"], got["ts"]).numpy())


def _lifecycle_equal(te, je):
    _store_equal(te, je)
    assert te.guard.used == je.guard.used
    assert te.store._binlog_base == je.store._binlog_base
    assert te.store._binlog_offset == je.store._binlog_offset
    assert te.store.binlog == je.store.binlog
    assert te._hwm_ts == je._hwm_ts
    assert te._pending_rows == je._pending_rows


def test_sustained_ingest_bounded_and_equal_to_reference():
    """Total ingest (400 rows) far past capacity (128): every
    ``compact_every`` = 48 rows the table is evicted and compacted, and
    after every chunk the port's store, guard and binlog equal the
    reference's bit for bit."""
    jt, tt = jax_tables(**SUSTAINED), torch_tables(**SUSTAINED)
    kw = dict(capacity=128, retention="auto", compact_every=48)
    je = JaxEngine(RET_SQL, jt, **kw)
    te = TorchEngine(RET_SQL, tt, device="cpu", **kw)
    assert te.retention_ms == {"actions": 5000}
    max_rows = max_binlog = ticks = 0
    for i in range(0, 400, 16):
        rows = [tt["actions"].row(j) for j in range(i, min(i + 16, 400))]
        je.ingest_many("actions", rows)
        te.ingest_many("actions", rows)
        _lifecycle_equal(te, je)
        ticks += te._pending_rows["actions"] == 0
        max_rows = max(max_rows, te.store.n_rows("actions"))
        max_binlog = max(max_binlog, len(te.store.binlog))
    assert ticks >= 8
    assert max_rows <= 128 and max_binlog <= 2 * 48 + 16
    assert te.store._binlog_offset == 400
    assert te.guard.used < 400 * (64 + 8 * 2)
    # served features equal the reference's (sums within reduction-order
    # tolerance of an unbounded engine, as the reference's own test)
    row = dict(tt["actions"].row(399))
    got, want = te.request(row), je.request(row)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    full = TorchEngine(RET_SQL, tt, capacity=1024, device="cpu")
    full.ingest_many("actions", [tt["actions"].row(j) for j in range(400)])
    for k, v in full.request(row).items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   rtol=1e-5, err_msg=k)


def test_single_row_ingest_ticks_like_the_reference():
    """``ingest`` (one row) drives the same retention ticks as the
    reference's single-row put path."""
    jt, tt = jax_tables(**SUSTAINED), torch_tables(**SUSTAINED)
    kw = dict(capacity=64, retention="auto", compact_every=8)
    je = JaxEngine(RET_SQL, jt, **kw)
    te = TorchEngine(RET_SQL, tt, device="cpu", **kw)
    for j in range(0, 120, 3):
        je.ingest("actions", jt["actions"].row(j))
        te.ingest("actions", tt["actions"].row(j))
    _lifecycle_equal(te, je)
    assert te.store._binlog_base > 0


def test_ttl_path_matches_reference():
    jt, tt = jax_tables(**SUSTAINED), torch_tables(**SUSTAINED)
    je = JaxEngine(RET_SQL, jt, capacity=256, ttl_ms=20_000)
    te = TorchEngine(RET_SQL, tt, capacity=256, ttl_ms=20_000, device="cpu")
    for i in range(0, 200, 20):
        rows = [tt["actions"].row(j) for j in range(i, i + 20)]
        je.ingest_many("actions", rows)
        te.ingest_many("actions", rows)
        _lifecycle_equal(te, je)
    assert te.store.n_rows("actions") < 200
    assert len(te.store.binlog) == 200     # ttl alone never truncates


def test_bulk_load_advances_the_watermark_without_a_tick():
    kw = dict(n_actions=120, n_orders=80, n_users=4, horizon_ms=120_000,
              seed=4, with_profile=False)
    jt, tt = jax_tables(**kw), torch_tables(**kw)
    ekw = dict(capacity=256, retention="auto", compact_every=16)
    je = JaxEngine(UNION_SQL, jt, **ekw)
    te = TorchEngine(UNION_SQL, tt, device="cpu", **ekw)
    for eng, t in ((je, jt), (te, tt)):
        eng.bulk_load("orders", t["orders"])
        eng.ingest_many("actions", [t["actions"].row(j) for j in range(40)])
    _lifecycle_equal(te, je)
    assert te._hwm_ts["orders"] == int(tt["orders"].columns["ts"].max())
    assert te.store.n_rows("actions") < 40
    assert te.store.n_rows("orders") == 80       # no orders tick yet


def test_memory_guard_credited_by_eviction():
    tt = torch_tables(**SUSTAINED)
    te = TorchEngine(RET_SQL, tt, capacity=128, retention="auto",
                     compact_every=16, max_memory_bytes=128 * 80,
                     device="cpu")
    for i in range(0, 400, 16):
        te.ingest_many("actions", [tt["actions"].row(j)
                                   for j in range(i, i + 16)])
    assert te.guard.used == te.store.n_rows("actions") * 80
    assert te.guard.rejected_writes == 0


# ------------------------------------------------------------ memory model


MEM_SPECS = [
    dict(name="actions", n_rows=1_000_000, avg_row_bytes=48.0, n_replicas=3,
         table_type="absolute", indexes=((100, 8), (5000, 16)),
         data_copies=2),
    dict(name="orders", n_rows=500_000, avg_row_bytes=24.5),
    dict(name="profile", n_rows=100, avg_row_bytes=12.0,
         table_type="absandlat", indexes=((100, 4),)),
]


def test_estimate_memory_matches_reference():
    want = jax_memest.estimate_memory(
        [jax_memest.TableMemSpec(**s) for s in MEM_SPECS])
    got = torch_memest.estimate_memory(
        [torch_memest.TableMemSpec(**s) for s in MEM_SPECS])
    assert got == want
    for bad in (dict(MEM_SPECS[1], table_type="columnar"),
                dict(MEM_SPECS[1], data_copies=2)):
        with pytest.raises(ValueError):
            torch_memest.estimate_memory([torch_memest.TableMemSpec(**bad)])


@pytest.mark.parametrize("est, avail, budget", [
    (1e9, 2e9, 10), (3e9, 2e9, 10), (1e9, 2e9, 25), (3e9, 2e9, 17),
    (1e9, 2e9, 17)])
def test_recommend_engine_matches_reference(est, avail, budget):
    assert (torch_memest.recommend_engine(est, avail, budget)
            == jax_memest.recommend_engine(est, avail, budget))
