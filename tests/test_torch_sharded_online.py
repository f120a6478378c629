"""Key-sharded online serving, port against reference: a
``FeatureEngine(n_shards=...)`` of each package fed the same rows,
served the same requests.  Counterparts of the reference's
``tests/test_sharded_online.py`` (all but the ``shard_map`` mesh cases):
raw and pre-aggregated parity, skewed keys and empty shards, parity
across a rebalance, transparent ``request`` / ``submit_request`` /
``flush``, LAST JOIN routing and the eligibility refusals, pre-agg bucket
planes after ``bulk_load``.  Bars: the port's sharded engine equals the
port's unsharded engine bit for bit; against the reference's sharded
engine, bitwise except ``ew`` at ``EW_RTOL`` / ``EW_ATOL``.

Port-only: a sharded batch calls the fused fold dispatch
(``unit_fold_ops.fold_env``) as often as an unsharded batch of the same
size; a ``ServeLoop`` over a sharded engine equals the reference's loop;
an ``EngineSnapshot`` cut before ``rebalance`` / ``kill_shard`` keeps
its bytes.
"""

import numpy as np
import pytest
import torch

from repro.core import compile_script as jax_compile
from repro.data.synthetic import make_action_tables as jax_tables
from repro.serve.engine import FeatureEngine as JaxEngine
from repro_torch.core import compile_script
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.kernels.unit_fold import ops as unit_fold_ops
from repro_torch.serve.engine import FeatureEngine

from torch_port_cases import ACTION_TABLES, EW_ATOL, EW_RTOL, SMOKE_SQL

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
SKEWED_TABLES = dict(n_actions=400, n_orders=0, n_users=12,
                     horizon_ms=120_000, zipf_alpha=1.3, seed=1,
                     with_profile=False)
SUM_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW)
"""
JOIN_SQL = """
SELECT price, profile.age AS age, sum(price) OVER w AS s
FROM actions
LAST JOIN profile ORDER BY ts ON actions.{key} = profile.userid
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW)
"""


def _assert_feats(got, want, loose=True):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            a, b = np.asarray(w[k]), np.asarray(g[k])
            if loose and k.startswith("ew"):
                np.testing.assert_allclose(b, a, rtol=EW_RTOL, atol=EW_ATOL,
                                           err_msg=f"req {i} {k}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"req {i} {k}")


def _trio(sql, tkw, n_ingest, load=("actions",), n_shards=4, capacity=1024,
          reference=True, **opts):
    """(port unsharded, port sharded, reference or None) engines fed
    identical ``ingest_many`` batches; returns them and the port's
    tables.  ``reference="unsharded"`` builds the reference's unsharded
    engine (sharded features equal unsharded ones bit for bit)."""
    tt = torch_tables(**tkw)
    engines = [FeatureEngine(sql, tt, capacity=capacity, device="cpu",
                             **opts),
               FeatureEngine(sql, tt, capacity=capacity, n_shards=n_shards,
                             device="cpu", **opts)]
    if reference:
        jt = jax_tables(**tkw)
        engines.append(JaxEngine(
            sql, jt, capacity=capacity,
            n_shards=None if reference == "unsharded" else n_shards, **opts))
    for tname in load:
        t = tt[tname]
        rows = [t.row(i) for i in range(min(n_ingest, len(t)))]
        for e in engines:
            e.ingest_many(tname, rows)
    return (engines + [None])[:3], tt


def _parity(engines, rows):
    plain, sharded, ref = engines
    got = sharded.request_batch([dict(r) for r in rows])
    _assert_feats(got, plain.request_batch([dict(r) for r in rows]),
                  loose=False)
    if ref is not None:
        _assert_feats(got, ref.request_batch([dict(r) for r in rows]))
    return got


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_sharded_parity_raw(micro_sql, fused):
    """The reference's micro script (staged, against the reference's
    sharded engine) and the smoke script (fused, the chip's path) over a
    UNION of both tables.  The fused case is held to the reference's
    unsharded fused engine: on the CPU the reference's sharded engines
    leave process state after which its fused engine fails on some batch
    sizes of such a script with an XLA buffer-count error, which other
    test files must not meet."""
    sql = SMOKE_SQL if fused else micro_sql
    engines, tt = _trio(sql, ACTION_TABLES, 60, load=("orders", "actions"),
                        fused_fold=fused,
                        reference="unsharded" if fused else True)
    a = tt["actions"]
    _parity(engines, [a.row(100 + i) for i in range(9)])
    plain, sharded, ref = engines
    for t in ("actions", "orders"):
        assert sharded.store.n_rows(t) == plain.store.n_rows(t)
        if not fused:
            np.testing.assert_array_equal(sharded.store.n_rows_per_shard(t),
                                          ref.store.n_rows_per_shard(t))


def test_sharded_parity_preagg():
    engines, tt = _trio(PREAGG_SQL, PREAGG_TABLES, 120, capacity=512,
                        use_preagg=True)
    _parity(engines, [tt["actions"].row(150 + i) for i in range(5)])
    # adaptive-hierarchy stats count real requests on the sharded path
    assert engines[1].cs.windows[0].preagg.query_stats == \
        engines[2].cs.windows[0].preagg.query_stats
    assert engines[1].cs.windows[0].preagg.query_stats["queries"] >= 5


def test_sharded_parity_skewed_keys():
    """Zipf keys: one hot key dominates and several shards stay empty."""
    engines, tt = _trio(SUM_SQL, SKEWED_TABLES, 200, n_shards=8)
    per_shard = engines[1].store.n_rows_per_shard("actions")
    assert per_shard.sum() == 200 and (per_shard == 0).any()
    _parity(engines, [tt["actions"].row(250 + i) for i in range(16)])


def test_sharded_empty_shard_edge():
    """All keys on a few shards; requests also hit a key whose shard holds
    no row (a cold key)."""
    tkw = dict(n_actions=80, n_orders=0, n_users=2, horizon_ms=60_000,
               seed=7, with_profile=False)
    engines, tt = _trio(SUM_SQL.replace("60s", "10s"), tkw, 60, n_shards=8,
                        capacity=256)
    assert (engines[1].store.n_rows_per_shard("actions") == 0).any()
    cold = dict(tt["actions"].row(70), userid=5)
    _parity(engines, [tt["actions"].row(70 + i) for i in range(4)] + [cold])


def test_sharded_rebalance_migrates_and_preserves():
    """Rebalance on skewed keys moves rows and pre-agg planes (the same
    routing as the reference's); features do not change."""
    engines, tt = _trio(PREAGG_SQL.replace("3000s", "30s"), SKEWED_TABLES,
                        200, capacity=512, use_preagg=True)
    plain, sharded, ref = engines
    rows = [tt["actions"].row(250 + i) for i in range(8)]
    before = _parity(engines, rows)
    assert sharded.rebalance() and ref.rebalance()
    assert sharded.store.n_rebalances == 1
    np.testing.assert_array_equal(sharded.store.assignment,
                                  ref.store.assignment)
    assert sharded.store.n_rows("actions") == 200
    np.testing.assert_array_equal(
        sharded.store.n_rows_per_shard("actions"),
        ref.store.n_rows_per_shard("actions"))
    for lvl in ("fine_epoch", "coarse_epoch"):
        np.testing.assert_array_equal(sharded.pre_states[0][lvl].numpy(),
                                      np.asarray(ref.pre_states[0][lvl]))
    _assert_feats(_parity(engines, rows), before, loose=False)


def test_engine_sharded_submit_flush_and_scalar_request(micro_sql):
    engines, tt = _trio(micro_sql, ACTION_TABLES, 40, load=("orders",),
                        reference=False)
    plain, sharded, _ = engines
    sharded.batcher.batch_size = 4
    reqs = [tt["actions"].row(10 + i) for i in range(6)]
    expect = plain.request_batch([dict(r) for r in reqs])
    single = sharded.request(dict(reqs[0]))
    _assert_feats([single], expect[:1], loose=False)
    rids = [sharded.submit_request(dict(r)) for r in reqs]
    out = sharded.flush()
    assert sorted(out) == sorted(rids)
    _assert_feats([out[r] for r in rids], expect, loose=False)
    assert sharded.n_requests == 1 + 6


@pytest.mark.parametrize("key,ok", [("category", False), ("userid", True)])
def test_sharded_last_join_routing(key, ok):
    """A LAST JOIN on the partition key serves from its shard (parity);
    one keyed off another column is refused, the joined row may live
    elsewhere."""
    sql = JOIN_SQL.format(key=key)
    tt = torch_tables(**ACTION_TABLES)
    cs_ok, why = compile_script(sql, tables=tt).sharded_eligible()
    assert (cs_ok, why) == jax_compile(
        sql, tables=jax_tables(**ACTION_TABLES)).sharded_eligible()
    if not ok:
        assert not cs_ok and "category" in why
        with pytest.raises(ValueError, match="shardable"):
            FeatureEngine(sql, tt, capacity=64, n_shards=2, device="cpu")
        return
    engines, tt = _trio(sql, ACTION_TABLES, 30, load=("profile", "actions"))
    _parity(engines, [tt["actions"].row(40 + i) for i in range(4)])


def test_sharded_rejects_multi_partition_script():
    sql = """
    SELECT sum(price) OVER w1 AS s1, sum(quantity) OVER w2 AS s2
    FROM actions
    WINDOW w1 AS (PARTITION BY userid ORDER BY ts
                  ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW),
          w2 AS (PARTITION BY category ORDER BY ts
                 ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW)
    """
    ok, why = compile_script(
        sql, tables=torch_tables(**ACTION_TABLES)).sharded_eligible()
    assert not ok and "multiple" in why


def test_bulk_load_folds_preagg_states():
    """Features over bulk-loaded history equal those over the same rows
    ingested, unsharded and sharded; the sharded planes after the load
    equal the reference's."""
    tt = torch_tables(**PREAGG_TABLES)
    a = tt["actions"]
    rows = [a.row(i) for i in range(len(a))]
    probe = [dict(a.row(180 + i)) for i in range(3)]
    outs = {}
    for mode in ("ingest", "bulk"):
        for n_shards in (None, 4):
            eng = FeatureEngine(PREAGG_SQL, tt, capacity=512,
                                use_preagg=True, n_shards=n_shards,
                                device="cpu")
            if mode == "ingest":
                eng.ingest_many("actions", rows)
            else:
                eng.bulk_load("actions", a)
            outs[(mode, n_shards)] = (eng, eng.request_batch(probe))
    want = outs[("ingest", None)][1]
    for key, (_, got) in outs.items():
        _assert_feats(got, want, loose=False)
    ref = JaxEngine(PREAGG_SQL, jax_tables(**PREAGG_TABLES), capacity=512,
                    use_preagg=True, n_shards=4)
    ref.bulk_load("actions", ref.tables["actions"])
    port = outs[("bulk", 4)][0]
    for lvl in ("fine", "coarse"):
        for k, v in ref.pre_states[0][lvl].items():
            got = port.pre_states[0][lvl][k].numpy()
            if k.startswith("ew"):
                np.testing.assert_allclose(got, np.asarray(v), rtol=1e-5,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(
            port.pre_states[0][f"{lvl}_epoch"].numpy(),
            np.asarray(ref.pre_states[0][f"{lvl}_epoch"]))


def test_sharded_preagg_request_outside_key_universe_raises():
    tt = torch_tables(**PREAGG_TABLES)
    eng = FeatureEngine(PREAGG_SQL, tt, capacity=256, use_preagg=True,
                        n_shards=2, device="cpu")
    n_keys = eng.cs.windows[0].preagg.n_keys
    with pytest.raises(ValueError, match="key universe"):
        eng.request_batch([dict(tt["actions"].row(0), userid=n_keys)])


@pytest.mark.parametrize("b", [1, 5, 64])
def test_sharded_batch_fold_dispatches_like_unsharded(monkeypatch, b):
    """The fused engine folds each window group once per batch, sharded or
    not: the fold dispatch (``fold_env``, which launches one unit-fold
    kernel on the card) is called as often for a sharded batch as for an
    unsharded batch of the same size."""
    calls = {"n": 0}
    real = unit_fold_ops.fold_env

    def counting(*args, **kw):
        calls["n"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(unit_fold_ops, "fold_env", counting)
    engines, tt = _trio(SMOKE_SQL, ACTION_TABLES, 100,
                        load=("orders", "actions"), n_shards=8,
                        reference=False, fused_fold=True)
    rows = [dict(tt["actions"].row(i % 300)) for i in range(b)]
    counts = []
    for eng in engines[:2]:
        calls["n"] = 0
        eng.request_batch(rows)
        counts.append(calls["n"])
    assert counts[0] == counts[1] == 2         # the groups w and wr


def test_serve_loop_over_sharded_engine_equals_reference():
    """One stimulus list through the port's ``ServeLoop`` over a sharded,
    replicated, fused engine with retention, and through the reference's
    loop over its unsharded engine: equal stats, shed decisions,
    latencies and feature bytes.  (The reference's loop over its own
    sharded engine stops on an XLA buffer-count error on the CPU, so the
    sharded side runs in the port only; sharded features equal unsharded
    ones bit for bit.)"""
    from repro.serve import trace as jax_trace
    from repro_torch.serve import trace as torch_trace
    from test_torch_serve_loop import LOOP_KW, RAW_SQL, _assert_results, \
        _service_ms, _stimuli

    tkw = dict(n_actions=180, n_orders=0, n_users=4, horizon_ms=300_000,
               seed=5, with_profile=False)
    opts = dict(fused_fold=True, retention="auto", compact_every=16)
    sharding = dict(n_shards=4, replication=1, ship_every=8,
                    device="cpu")
    loops = []
    events_json = None
    for tables, Engine, trace, kw in (
            (jax_tables(**tkw), JaxEngine, jax_trace, {}),
            (torch_tables(**tkw), FeatureEngine, torch_trace, sharding)):
        if events_json is None:
            events_json = _stimuli(tables, 3)
        events = [trace.TraceEvent.from_json(d) for d in events_json]
        loop = trace.replay(
            events, lambda: Engine(RAW_SQL, tables, capacity=512, **opts,
                                   **kw),
            service_model=_service_ms, **LOOP_KW)
        loop.run_until_idle()
        loops.append(loop)
    ref, port = loops
    assert port.stats == ref.stats and port.stats["served"] > 0
    assert port.stats["snapshot_swaps"] > 2
    assert port.latencies == ref.latencies
    _assert_results(port.results, ref.results)
    eng = port.engine
    assert eng.sharded and eng.store.n_rows("actions") == \
        ref.engine.store.n_rows("actions")
    # truncation never passes what every follower applied, nor the
    # recovery snapshot's watermark (never re-cut here, so the log stays)
    st = eng.replication_stats()
    assert eng.store._binlog_base <= min(st["safe_offset"],
                                         st["snapshot_watermark"])
    assert st["n_shipped"] > 0 and st["max_lag_entries"] < 8 + 6


def test_snapshot_keeps_bytes_across_rebalance_and_kill():
    """A snapshot cut before ``rebalance`` and ``kill_shard`` serves the
    same bytes after both (frozen tables, planes and routing), and equals
    the unsharded engine."""
    tt = torch_tables(**SKEWED_TABLES)
    sql = PREAGG_SQL.replace("3000s", "30s")
    sharded = FeatureEngine(sql, tt, capacity=512, use_preagg=True,
                            n_shards=4, replication=1, device="cpu")
    plain = FeatureEngine(sql, tt, capacity=512, use_preagg=True,
                          device="cpu")
    rows = [tt["actions"].row(i) for i in range(200)]
    for e in (sharded, plain):
        e.ingest_many("actions", rows)
    probe = [dict(tt["actions"].row(250 + i)) for i in range(6)]
    snap = sharded.snapshot()
    before = sharded.request_batch(probe, snapshot=snap)
    assert sharded.rebalance()
    sharded.kill_shard(int(sharded.store.owner_of_keys(
        [probe[0]["userid"]])[0]))
    _assert_feats(sharded.request_batch(probe, snapshot=snap), before,
                  loose=False)
    _assert_feats(before, plain.request_batch(probe), loose=False)
    sharded.heal()
    snap.refresh()
    _assert_feats(sharded.request_batch(probe, snapshot=snap), before,
                  loose=False)
    assert isinstance(snap.store.tables["actions"]["keys"], torch.Tensor)
