"""Long-window pre-aggregation (§5.1), port against reference.

Bucket planes after ``update`` / ``update_many`` (in order, out of order,
timestamps before 0 so that window starts and bucket ids are negative),
``fold_online``, engine requests with ``use_preagg`` and
``verify_consistency(use_preagg=True)`` run in both packages on the same
numpy-seeded inputs.  Bars (rule C-PREAGG-FLOAT is the reference's own):

* planes and folds: bitwise for sum/count, min/max, the histogram and the
  HLL sketch; drawdown and EW planes at ``PLANE_RTOL`` / ``PLANE_ATOL``
  (XLA may contract their combines);
* pre-agg features: bitwise where the columns are, EW at ``EW_RTOL``;
* pre-agg serving against ``offline()``: the reference gate's rtol 1e-4 /
  atol 1e-3, or bitwise where the reference's own tests gate bitwise
  (integer-valued prices, order-insensitive leaves).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile_script as jax_compile
from repro.core import parse as jax_parse
from repro.core import replay_online as jax_replay
from repro.core import functions as jf
from repro.core.preagg import PreAgg as JaxPreAgg
from repro.core.window import WindowSpec as JaxSpec
from repro.data.synthetic import make_action_tables as jax_tables
from repro.serve.engine import FeatureEngine as JaxEngine
from repro.storage import timestore as jax_ts
from repro_torch.core import compile_script as torch_compile
from repro_torch.core import functions as tf
from repro_torch.core import replay_online, verify_consistency
from repro_torch.core.lowering.windows import gather_edges
from repro_torch.core.preagg import PreAgg
from repro_torch.core.window import WindowSpec
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.serve.engine import FeatureEngine as TorchEngine
from repro_torch.storage import timestore as torch_ts

from torch_port_cases import EW_ATOL, EW_RTOL

PLANE_RTOL, PLANE_ATOL = 1e-5, 1e-6
LOOSE = ("dd:x", "ew:x")
# HLL estimates sum exp2(-registers) in f32, in an order XLA and torch
# may choose differently (the registers themselves are bitwise)
HLL_RTOL = 1e-6

# the reference's tests/test_online_batch.py PREAGG_SQL and
# tests/test_consistency.py::test_consistency_with_preagg
PREAGG_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       min(price) OVER w AS mn, max(price) OVER w AS mx,
       ew_avg(price, 0.5) OVER w AS ew
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 3000s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "w:100s")
"""
PREAGG_TABLES = dict(n_actions=200, n_orders=0, n_users=4,
                     horizon_ms=12_000_000, seed=4, with_profile=False)
# tests/test_fold_engine.py::test_hll_distinct_count_in_preagg_planes
HLL_SQL = """
SELECT distinct_count(category) OVER w AS dc, count(price) OVER w AS c
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 3000s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "w:100s")
"""
HLL_CTX = dict(distinct_hll_p=6, cardinality_overrides={"category": 256},
               distinct_hll_min_card=128)
# every combine family in one long window over a UNION, plus a raw
# short window beside it
FAMILY_SQL = """
SELECT sum(price) OVER wl AS s_l, count(price) OVER wl AS c_l,
  min(price) OVER wl AS mn_l, max(price) OVER wl AS mx_l,
  distinct_count(category) OVER wl AS dc_l,
  topn_frequency(category, 3) OVER wl AS tn_l,
  drawdown(price) OVER wl AS dd_l, ew_avg(price, 0.5) OVER wl AS ew_l,
  sum(price) OVER w AS s, count(price) OVER w AS c
FROM actions
WINDOW wl AS (UNION orders PARTITION BY userid ORDER BY ts
              ROWS_RANGE BETWEEN 3000s PRECEDING AND CURRENT ROW),
       w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 10s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "wl:100s")
"""
FAMILY_TABLES = dict(n_actions=90, n_orders=60, n_users=4,
                     horizon_ms=12_000_000, seed=104, with_profile=False)

# the pre-agg rows of tests/test_fold_engine.py's sweep (row 6 without
# its key sharding, which is not ported): seed, aggregates drawn, union
FOLD_SWEEP = [(4, 4, False), (6, 3, False)]
PREAGG_SAFE_AGGS = [
    "sum(price)", "avg(price)", "count(price)", "min(price)",
    "max(price)", "stddev(price)", "distinct_count(category)",
    "topn_frequency(category, 3)",
]


def _int_prices(tables):
    """Integer-valued float32 prices: every combine bracketing exact."""
    for t in tables.values():
        if "price" in t.columns:
            t.columns["price"] = np.floor(t.columns["price"]).astype(
                np.float32)
    return tables


def _pair(**kw):
    """(reference PreAgg, port PreAgg) over column ``x`` (and a code
    column ``c`` for the histogram and the HLL sketch), every family."""
    jv = lambda env: jnp.asarray(env["x"])            # noqa: E731
    tv = lambda env: env["x"]                          # noqa: E731
    jc = lambda env: jf.jax_one_hot(jnp.asarray(env["c"]).astype(  # noqa
        jnp.int32), 8)
    tc = lambda env: (env["c"].to(torch.int32)[..., None]          # noqa
                      == torch.arange(8, dtype=torch.int32)).to(
                          torch.float32)
    jleaves = {
        "sum:x": jf.AddLeaf("sum:x", jv), "min:x": jf.MinLeaf("min:x", jv),
        "max:x": jf.MaxLeaf("max:x", jv),
        "dd:x": jf.DrawdownLeaf("dd:x", jv),
        "ew:x": jf.EWLeaf("ew:x", jv, decay=0.6),
        "hist:c": jf.AddLeaf("hist:c", jc, shape=(8,)),
        "hll:c": jf.HLLLeaf("hll:c", lambda env: jnp.asarray(env["c"]),
                            p=4),
    }
    tleaves = {
        "sum:x": tf.AddLeaf("sum:x", tv), "min:x": tf.MinLeaf("min:x", tv),
        "max:x": tf.MaxLeaf("max:x", tv),
        "dd:x": tf.DrawdownLeaf("dd:x", tv),
        "ew:x": tf.EWLeaf("ew:x", tv, decay=0.6),
        "hist:c": tf.AddLeaf("hist:c", tc, shape=(8,)),
        "hll:c": tf.HLLLeaf("hll:c", lambda env: env["c"], p=4),
    }
    args = dict(bucket_ms=100, window_ms=10_000, n_keys=8,
                value_cols=("c", "x"), fanout=4)
    args.update(kw)
    return (JaxPreAgg(spec=JaxSpec("w", "k", "ts", 10_000), leaves=jleaves,
                      **args),
            PreAgg(spec=WindowSpec("w", "k", "ts", 10_000), leaves=tleaves,
                   **args))


def _rows(n, seed, t_lo=-4_000, t_hi=3_000, sort=True):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 8, n).astype(np.int32)
    ts = rng.integers(t_lo, t_hi, n).astype(np.int32)
    if sort:
        ts = np.sort(ts)
    x = (rng.normal(size=n) + 2.0).astype(np.float32)
    x[rng.integers(0, n)] = np.nan
    c = rng.integers(0, 8, n).astype(np.float32)
    return keys, ts, {"x": x, "c": c}


def _assert_planes(got, want):
    for lvl in ("fine", "coarse"):
        for k, v in want[lvl].items():
            g, w = got[lvl][k].numpy(), np.asarray(v)
            if k in LOOSE:
                np.testing.assert_allclose(g, w, rtol=PLANE_RTOL,
                                           atol=PLANE_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{lvl}/{k}")
        np.testing.assert_array_equal(got[f"{lvl}_epoch"].numpy(),
                                      np.asarray(want[f"{lvl}_epoch"]))


@pytest.mark.parametrize("order", ["in-order", "out-of-order"])
def test_update_many_matches_reference(order):
    """Timestamps from -4 s: bucket ids and ring slots below 0."""
    jpa, tpa = _pair()
    keys, ts, vals = _rows(61, 3, sort=order == "in-order")
    assert tpa._batch_in_order(keys, ts) == (order == "in-order")
    want = jpa.update_many(jpa.init_state(), keys, ts, vals)
    got = tpa.update_many(tpa.init_state("cpu"), keys, ts, vals)
    _assert_planes(got, want)
    assert int(got["fine_epoch"].min()) < -1
    # a second batch on top, past the ring's capacity
    k2, t2, v2 = _rows(40, 4, t_lo=3_000, t_hi=9_000)
    _assert_planes(tpa.update_many(got, k2, t2, v2),
                   jpa.update_many(want, k2, t2, v2))


@pytest.mark.parametrize("order", ["in-order", "out-of-order"])
def test_update_equals_update_many(order):
    """Row-by-row ``update`` and one ``update_many``: the same bits, also
    when timestamps regress within a key (the run-splitting path)."""
    _, tpa = _pair()
    keys, ts, vals = _rows(37, 5, sort=order == "in-order")
    seq = tpa.init_state("cpu")
    for i in range(keys.shape[0]):
        seq = tpa.update(seq, int(keys[i]), int(ts[i]),
                         {c: v[i] for c, v in vals.items()})
    bat = tpa.update_many(tpa.init_state("cpu"), keys, ts, vals)
    for lvl in ("fine", "coarse"):
        for k in seq[lvl]:
            np.testing.assert_array_equal(seq[lvl][k].numpy(),
                                          bat[lvl][k].numpy(), err_msg=k)
        np.testing.assert_array_equal(seq[f"{lvl}_epoch"].numpy(),
                                      bat[f"{lvl}_epoch"].numpy())


def test_in_order_detection_and_run_cuts():
    keys = np.array([1, 2, 1, 2, 1, 1], np.int32)
    for ts in (np.array([5, 1, 6, 2, 7, 9], np.int32),
               np.array([5, 1, 4, 2, 3, 9], np.int32)):
        assert PreAgg._batch_in_order(keys, ts) == \
            JaxPreAgg._batch_in_order(keys, ts)
        assert PreAgg._ordered_run_cuts(keys, ts) == \
            JaxPreAgg._ordered_run_cuts(keys, ts)


def test_hierarchy_stats_match_reference():
    jpa, tpa = _pair(fanout=16)
    for t in (-5_000, 0, 99, 8_123, 55_555):
        jpa.observe_query(t)
        tpa.observe_query(t)
    assert tpa.query_stats == jpa.query_stats
    assert tpa.suggest_hierarchy() == jpa.suggest_hierarchy()
    assert (tpa.n_fine, tpa.n_coarse, tpa.max_coarse_q) == \
        (jpa.n_fine, jpa.n_coarse, jpa.max_coarse_q)


def test_fold_online_matches_reference():
    """Edges from the store, buckets from the planes, for a batch of
    requests whose windows start before 0."""
    jpa, tpa = _pair()
    keys, ts, vals = _rows(300, 8, t_lo=-4_000, t_hi=12_000)
    jst = jax_ts.OnlineStore(capacity=512)
    tst = torch_ts.OnlineStore(capacity=512, device="cpu")
    for st in (jst, tst):
        st.create_table("t", {"c": np.float32, "x": np.float32})
        st.put_many("t", keys, ts, vals)
    jstate = jpa.update_many(jpa.init_state(), keys, ts, vals)
    tstate = tpa.update_many(tpa.init_state("cpu"), keys, ts, vals)

    class W:                        # the window fields the gather reads
        sources = ("t",)
        needed_cols = ("c", "x")

    jw_, tw_ = W(), W()
    jw_.preagg, tw_.preagg = jpa, tpa
    rq_k = np.array([0, 3, 5, 7, 3], np.int32)
    rq_t = np.array([-1_500, 2_345, 9_999, 12_000, 11_050], np.int32)
    rq_v = {"x": np.array([1.5, 2.5, np.nan, 4.0, 0.5], np.float32),
            "c": np.array([1, 2, 3, 4, 5], np.float32)}
    got = tpa.fold_online(tst.tables, tw_, torch.from_numpy(rq_k),
                          torch.from_numpy(rq_t),
                          {c: torch.from_numpy(v) for c, v in rq_v.items()},
                          tstate, gather=gather_edges)
    from repro.core.lowering.windows import gather_edges as jax_edges
    for i in range(rq_k.shape[0]):
        want = jpa.fold_online(
            jst.tables, jw_, jnp.int32(rq_k[i]), jnp.int32(rq_t[i]),
            {c: jnp.float32(v[i]) for c, v in rq_v.items()}, jstate,
            gather=jax_edges)
        for k, v in want.items():
            g, w = got[k][i].numpy(), np.asarray(v)
            if k in LOOSE:
                np.testing.assert_allclose(g, w, rtol=EW_RTOL,
                                           atol=EW_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)


def _close(name, got, want, hll=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if hll:
        np.testing.assert_allclose(got, want, rtol=HLL_RTOL, err_msg=name)
    elif name.startswith(("ew", "dd")):
        np.testing.assert_allclose(got, want, rtol=EW_RTOL, atol=EW_ATOL,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
@pytest.mark.parametrize("which", ["preagg", "family"])
def test_engine_preagg_requests_match_reference(which, fused):
    sql, kw = ((PREAGG_SQL, PREAGG_TABLES) if which == "preagg"
               else (FAMILY_SQL, FAMILY_TABLES))
    jt, tt = jax_tables(**kw), torch_tables(**kw)
    je = JaxEngine(sql, jt, capacity=512, use_preagg=True, fused_fold=fused)
    te = TorchEngine(sql, tt, capacity=512, use_preagg=True,
                     fused_fold=fused, device="cpu")
    a = jt["actions"]
    for eng, t in ((je, jt), (te, tt)):
        if "orders" in eng._need:
            eng.bulk_load("orders", t["orders"])
        eng.ingest_many("actions", [t["actions"].row(i) for i in range(60)])
        for i in range(60, 64):
            eng.ingest("actions", t["actions"].row(i))
    _assert_planes_engines(te, je)
    rows = [dict(a.row(70 + i)) for i in range(5)]
    want = je.request_batch(rows)
    got = te.request_batch(rows)
    for w, g in zip(want, got):
        for k in w:
            _close(k, g[k], w[k])
    for row, g in zip(rows, got):
        one = te.request(row)
        for k in one:
            np.testing.assert_array_equal(one[k], g[k], err_msg=k)


def _assert_planes_engines(te, je):
    for wi, st in je.pre_states.items():
        got = te.pre_states[wi]
        for lvl in ("fine", "coarse"):
            for k, v in st[lvl].items():
                g, w = got[lvl][k].numpy(), np.asarray(v)
                if k.startswith(("dd:", "ew:")):
                    np.testing.assert_allclose(g, w, rtol=PLANE_RTOL,
                                               atol=PLANE_ATOL, err_msg=k)
                else:
                    np.testing.assert_array_equal(g, w, err_msg=k)


CONSISTENCY_CASES = {
    "preagg": (PREAGG_SQL, PREAGG_TABLES, {}, False),
    "hll": (HLL_SQL, dict(n_actions=120, n_orders=0, n_users=4,
                          horizon_ms=12_000_000, seed=7,
                          with_profile=False), HLL_CTX, True),
    "family-int": (FAMILY_SQL, FAMILY_TABLES, {}, False),
}


@pytest.mark.parametrize("which", sorted(CONSISTENCY_CASES))
def test_replay_with_preagg_matches_reference(which):
    sql, kw, ctx, bitwise = CONSISTENCY_CASES[which]
    jt, tt = jax_tables(**kw), torch_tables(**kw)
    if which.endswith("int"):
        _int_prices(jt)
        _int_prices(tt)
    jcs = jax_compile(jax_parse(sql), tables=jt, **ctx)
    tcs = torch_compile(sql, tables=tt, **ctx)
    assert tcs.windows[0].preagg is not None
    want = jax_replay(jcs, jt, use_preagg=True)
    got = replay_online(tcs, tt, use_preagg=True, device="cpu")
    for k in want:
        _close(k, got[k], want[k], hll=bool(ctx) and k == "dc")
    rep = verify_consistency(tcs, tt, use_preagg=True, bitwise=bitwise,
                             device="cpu")
    assert rep.passed, str(rep)
    assert verify_consistency(tcs, tt, use_preagg=False,
                              device="cpu").passed


@pytest.mark.parametrize("seed,n_aggs,union", FOLD_SWEEP)
def test_fold_engine_sweep_preagg_rows(seed, n_aggs, union):
    """The pre-agg rows of the reference's sweep: integer-valued prices,
    order-insensitive leaves, the bitwise gate."""
    rng = np.random.default_rng(seed)
    aggs = list(rng.choice(PREAGG_SAFE_AGGS, size=n_aggs, replace=False))
    sel = ",\n  ".join(f"{a} OVER w AS f{i}" for i, a in enumerate(aggs))
    sql = (f"SELECT\n  {sel}\nFROM actions\nWINDOW w AS (PARTITION BY "
           f"userid ORDER BY ts ROWS_RANGE BETWEEN 3000s PRECEDING AND "
           f"CURRENT ROW)\nOPTIONS (long_windows = \"w:100s\")")
    kw = dict(n_actions=90, n_orders=0, n_users=4, horizon_ms=12_000_000,
              seed=100 + seed, with_profile=False)
    tt = _int_prices(torch_tables(**kw))
    cs = torch_compile(sql, tables=tt)
    rep = verify_consistency(cs, tt, use_preagg=True, bitwise=True,
                             device="cpu")
    assert rep.passed and rep.bitwise_equal, f"{sql}\n{rep}"


def test_long_window_offline_matches_reference():
    """A long-window script compiles, and ``offline()`` (which folds the
    raw rows) equals the reference's."""
    jt, tt = jax_tables(**FAMILY_TABLES), torch_tables(**FAMILY_TABLES)
    want = jax_compile(FAMILY_SQL, tables=jt).offline(jt)
    got = torch_compile(FAMILY_SQL, tables=tt).offline(tt, device="cpu")
    for k in want:
        _close(k, got[k], want[k])


def test_planes_are_sized_like_the_reference():
    jt, tt = jax_tables(**FAMILY_TABLES), torch_tables(**FAMILY_TABLES)
    jpa = jax_compile(FAMILY_SQL, tables=jt).windows[0].preagg
    tpa = torch_compile(FAMILY_SQL, tables=tt).windows[0].preagg
    for f in ("n_keys", "n_fine", "n_coarse", "max_coarse_q",
              "max_bucket_rows", "bucket_ms", "coarse_ms", "value_cols"):
        assert getattr(tpa, f) == getattr(jpa, f), f
    st = tpa.init_state("cpu")
    assert tpa.plane_bytes(st) == sum(
        np.asarray(v).nbytes for lvl in ("fine", "coarse")
        for v in list(jpa.init_state()[lvl].values())
        + [jpa.init_state()[f"{lvl}_epoch"]])


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_long_deployment_certificate():
    """``chip_smoke.py``'s long-window deployment, as the reference sees
    it: the planes it builds, and over the gate's thinned tables (every
    ``GATE_STRIDE``-th row) a certificate with no C-BUF, C-PREAGG-EDGE or C-KEYCARD
    hit, whose bitwise columns under pre-agg are the ones the card's gate
    holds bitwise."""
    from repro.core.analysis.certificate import certify
    from repro.core.types import Table

    cz = _chip_smoke()
    full = jax_tables(**cz.DEPLOYMENT_LONG)
    thin = {n: Table(t.schema, {c: v[::cz.GATE_STRIDE]
                                for c, v in t.columns.items()},
                     dicts=t.dicts) for n, t in full.items()}
    cs = jax_compile(jax_parse(cz.LONG_SQL), tables=thin)
    pa = next(w.preagg for w in cs.windows if w.preagg is not None)
    assert (pa.n_keys, pa.n_fine, pa.n_coarse, pa.max_coarse_q,
            pa.max_bucket_rows) == cz.LONG_PLANES
    tpa = next(w.preagg for w in torch_compile(
        cz.LONG_SQL, tables=torch_tables(**dict(
            cz.DEPLOYMENT_LONG, n_actions=300, n_orders=100))).windows
        if w.preagg is not None)
    assert (tpa.n_keys, tpa.n_fine, tpa.n_coarse, tpa.max_coarse_q,
            tpa.max_bucket_rows) == cz.LONG_PLANES
    cert = certify(cs, tables=thin)
    hits = {r["rule"] for col in cert.consistency["columns"].values()
            for r in col["rules"]}
    assert not hits & {"C-BUF", "C-PREAGG-EDGE", "C-KEYCARD"}, hits
    assert tuple(cert.bitwise_columns("preagg")) == cz.GATE_BITWISE
