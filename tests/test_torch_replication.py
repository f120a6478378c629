"""Replicated shards, port against reference: binlog shipping, failover
and bitwise recovery (``storage.replication`` and
``FeatureEngine(n_shards=..., replication=R)``) — counterparts of every
test of the reference's ``tests/test_replication.py``.

The gate: a shard can die mid-traffic and, after its most-caught-up
follower is promoted and the unacked binlog tail replayed, serving is
bitwise that of an engine never killed, raw and with pre-agg.  Followers
are held to their leader's slice bit for bit; ``ReplicationLog`` lag and
``safe_offset``, the stats and the ``PromotionRecord`` fields other than
``recovery_s`` to the reference's on the same rows; features to the
reference's sharded engine (``ew`` at ``EW_RTOL`` / ``EW_ATOL``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_action_tables as jax_tables
from repro.distributed.fault import CheckpointManager as JaxCheckpoint
from repro.serve.engine import FeatureEngine as JaxEngine
from repro.storage.replication import FailoverController as JaxController
from repro.storage.replication import ReplicationLog as JaxLog
from repro.storage.replication import ReplicationManager as JaxManager
from repro.storage.replication import cold_recover_shard as jax_cold
from repro.storage.timestore import ShardedOnlineStore as JaxStore
from repro_torch.core import compile_script, verify_consistency
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.distributed.fault import CheckpointManager
from repro_torch.serve.engine import FeatureEngine
from repro_torch.storage.replication import (FailoverController,
                                             ReplicationLog,
                                             ReplicationManager,
                                             cold_recover_shard)
from repro_torch.storage.timestore import ShardedOnlineStore

from torch_port_cases import EW_ATOL, EW_RTOL

SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       min(price) OVER w AS mn, max(price) OVER w AS mx
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW)
"""

PREAGG_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       min(price) OVER w AS mn, max(price) OVER w AS mx,
       ew_avg(price, 0.5) OVER w AS ew
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 3000s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "w:100s")
"""


def _store(n_shards=4, capacity=256, port=True):
    st = (ShardedOnlineStore(capacity=capacity, n_shards=n_shards,
                             device="cpu") if port else
          JaxStore(capacity=capacity, n_shards=n_shards))
    st.create_table("actions", {"price": np.float32, "quantity": np.int32})
    return st


def _feed(stores, n, seed=0, start_off=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 12, n).astype(np.int32)
    ts = (np.arange(n, dtype=np.int32) + start_off) * 10
    cols = {"price": rng.normal(5, 2, n).astype(np.float32),
            "quantity": rng.integers(1, 5, n).astype(np.float32)}
    for st in stores:
        st.put_many("actions", keys, ts, cols)
    return keys


def _assert_slice(got, want):
    """A port slice (tensors) against a port or reference slice."""
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    want = jax.device_get(want) if not isinstance(want["keys"],
                                                  torch.Tensor) else want
    for k in ("keys", "ts", "count"):
        np.testing.assert_array_equal(host(got[k]), host(want[k]), err_msg=k)
    for c in want["cols"]:
        np.testing.assert_array_equal(host(got["cols"][c]),
                                      host(want["cols"][c]), err_msg=c)


def _assert_follower(store, mgr, shard, replica=0):
    _assert_slice(mgr.followers[(shard, replica)].tables["actions"],
                  store.shard_state("actions", shard))


# --------------------------------------------------------------- log


def test_replication_log_ack_lag_safe_offset():
    logs = [ReplicationLog(n_shards=3, n_replicas=2),
            JaxLog(n_shards=3, n_replicas=2)]
    for log in logs:
        log.ack(0, 0, 10)
        log.ack(0, 1, 7)
        log.ack(0, 0, 4)           # acks never regress
    port, ref = logs
    assert port.acked[0, 0] == 10
    assert port.lag(12)[0].tolist() == [2, 5]
    np.testing.assert_array_equal(port.lag(12), ref.lag(12))
    assert port.max_lag(12) == ref.max_lag(12) == 12
    assert port.safe_offset() == ref.safe_offset() == 0
    for log in logs:
        for s in range(3):
            for r in range(2):
                log.ack(s, r, 6 + s)
    assert port.safe_offset() == ref.safe_offset() == 7
    assert port.most_caught_up(0) == ref.most_caught_up(0) == 0


# ------------------------------------------------------------ shipping


def test_ship_makes_followers_bitwise_equal():
    store, ref = _store(), _store(port=False)
    mgr = ReplicationManager(store, n_replicas=2)
    rmgr = JaxManager(ref, n_replicas=2)
    _feed((store, ref), 40, seed=1)
    _feed((store, ref), 25, seed=2, start_off=40)
    assert mgr.stats()["max_lag_entries"] == 65
    assert mgr.ship() == rmgr.ship() > 0
    assert mgr.stats() == rmgr.stats()
    for s in range(store.n_shards):
        for r in range(2):
            _assert_follower(store, mgr, s, r)
            _assert_slice(mgr.followers[(s, r)].tables["actions"],
                          rmgr.followers[(s, r)].tables["actions"])


def test_ship_is_incremental_and_batch_boundary_independent():
    a, b = _store(), _store()
    ma = ReplicationManager(a, n_replicas=1)
    mb = ReplicationManager(b, n_replicas=1)
    for i in range(5):
        _feed((a, b), 13, seed=i, start_off=13 * i)
        ma.ship()                       # eager: 5 small tails
    mb.ship()                           # lazy: one 65-entry tail
    for s in range(a.n_shards):
        _assert_slice(ma.followers[(s, 0)].tables["actions"],
                      mb.followers[(s, 0)].tables["actions"])
        _assert_follower(a, ma, s)


def test_truncation_clamped_to_safe_offset():
    store = _store()
    mgr = ReplicationManager(store, n_replicas=1)
    _feed((store,), 30)
    mgr.ship()
    _feed((store,), 10, seed=3, start_off=30)   # unshipped tail
    assert mgr.log.safe_offset() == 30
    store.truncate_binlog(mgr.log.safe_offset())
    mgr.ship()                                  # tail still readable
    for s in range(store.n_shards):
        _assert_follower(store, mgr, s)
    with pytest.raises(ValueError, match="truncated"):
        store.read_binlog(10)


# ------------------------------------------------------------ failover


def test_promote_replays_unacked_tail_bitwise():
    """Followers lag by an unshipped tail; the shard dies; promotion
    replays the tail: the leader slot equals a store that never failed,
    and the record equals the reference's."""
    store, never, ref = _store(), _store(), _store(port=False)
    mgr = ReplicationManager(store, n_replicas=2)
    rmgr = JaxManager(ref, n_replicas=2)
    ctl, rctl = FailoverController(mgr), JaxController(rmgr)
    _feed((store, never, ref), 40, seed=5)
    mgr.ship()
    rmgr.ship()
    _feed((store, never, ref), 17, seed=6, start_off=40)
    dead = 2
    assert mgr.log.max_lag(store._binlog_offset) == 17
    for st, c in ((store, ctl), (ref, rctl)):
        st.wipe_shard(dead)
        c.mark_dead(dead)
    assert ctl.dead_shards() == [dead]
    rec, rrec = ctl.failover(dead), rctl.failover(dead)
    got, want = dataclasses.asdict(rec), dataclasses.asdict(rrec)
    got.pop("recovery_s"), want.pop("recovery_s")
    assert got == want and rec.replayed_entries == 17
    assert ctl.dead_shards() == []
    _assert_slice(store.shard_state("actions", dead),
                  never.shard_state("actions", dead))
    _assert_slice(store.shard_state("actions", dead),
                  ref.shard_state("actions", dead))
    _assert_follower(store, mgr, dead, rec.replica)
    assert mgr.stats() == rmgr.stats()


def test_heartbeat_driven_failover():
    store = _store()
    mgr = ReplicationManager(store, n_replicas=1)
    ctl = FailoverController(mgr, timeout_s=5.0, now=100.0)
    _feed((store,), 20)
    mgr.ship()
    ctl.beat(now=110.0)
    assert ctl.dead_shards(now=112.0) == []
    store.wipe_shard(1)
    for s in (0, 2, 3):                      # shard 1 stops beating
        ctl.beat(s, now=120.0)
    assert ctl.dead_shards(now=120.0) == [1]
    recs = ctl.check(now=120.0)
    assert [r.shard for r in recs] == [1]
    assert ctl.dead_shards(now=120.0) == []
    _assert_follower(store, mgr, 1)


def test_cold_recover_from_checkpoint_plus_binlog(tmp_path):
    """No follower survives: restore the shard from the checkpoint cut at
    a binlog watermark and replay the tail — equal to a store that never
    failed, and to the reference's recovery."""
    store, never, ref = _store(), _store(), _store(port=False)
    ckpt = CheckpointManager(str(tmp_path / "port"))
    rckpt = JaxCheckpoint(str(tmp_path / "ref"))
    _feed((store, never, ref), 30, seed=8)
    wm = store._binlog_offset
    ckpt.save(wm, dict(store.tables))
    rckpt.save(wm, {t: ref.tables[t] for t in ref.tables})
    _feed((store, never, ref), 15, seed=9, start_off=30)
    dead = 0
    store.wipe_shard(dead)
    ref.wipe_shard(dead)
    replayed = cold_recover_shard(store, ckpt, dead)
    assert replayed == jax_cold(ref, rckpt, dead) > 0
    _assert_slice(store.shard_state("actions", dead),
                  never.shard_state("actions", dead))
    _assert_slice(store.shard_state("actions", dead),
                  ref.shard_state("actions", dead))


# ------------------------------------------------- engine kill -> heal


def _tables(pkg, n=240, seed=11, horizon=12_000_000):
    return pkg(n_actions=n, n_orders=0, n_users=6, horizon_ms=horizon,
               seed=seed, with_profile=False)


def _engines(sql, n=240, seed=11, horizon=12_000_000, use_preagg=False,
             replication=1, reference=True, **kw):
    """(port unsharded, port replicated sharded, reference replicated
    sharded or None) and the port's tables."""
    tt = _tables(torch_tables, n, seed, horizon)
    out = [FeatureEngine(sql, tt, capacity=1024, use_preagg=use_preagg,
                         device="cpu", **{k: v for k, v in kw.items()
                                          if k in ("retention",
                                                   "compact_every")}),
           FeatureEngine(sql, tt, capacity=1024, use_preagg=use_preagg,
                         n_shards=4, replication=replication,
                         device="cpu", **kw)]
    out.append(JaxEngine(sql, _tables(jax_tables, n, seed, horizon),
                         capacity=1024, use_preagg=use_preagg, n_shards=4,
                         replication=replication, **kw)
               if reference else None)
    return out, tt


def _ingest(engines, table, rows):
    for e in engines:
        if e is not None:
            e.ingest_many(table, rows)


def _parity(engines, rows):
    plain, rep, ref = engines
    got = rep.request_batch([dict(r) for r in rows])
    want = plain.request_batch([dict(r) for r in rows])
    for i in range(len(rows)):
        for k in want[i]:
            np.testing.assert_array_equal(np.asarray(got[i][k]),
                                          np.asarray(want[i][k]),
                                          err_msg=f"req {i} feature {k}")
    if ref is not None:
        want = ref.request_batch([dict(r) for r in rows])
        for i in range(len(rows)):
            for k in want[i]:
                a, b = np.asarray(want[i][k]), np.asarray(got[i][k])
                if k == "ew":
                    np.testing.assert_allclose(b, a, rtol=EW_RTOL,
                                               atol=EW_ATOL)
                else:
                    np.testing.assert_array_equal(b, a, err_msg=k)


def _same_stats(port, ref):
    st, rs = port.replication_stats(), ref.replication_stats()
    for k in ("n_replicas", "leader_offset", "acked", "lag_entries",
              "max_lag_entries", "max_lag_seen", "safe_offset",
              "n_shipped", "snapshot_watermark", "dead_shards"):
        assert st[k] == rs[k], k
    got = [{k: v for k, v in f.items() if k != "recovery_s"}
           for f in st["failovers"]]
    assert got == [{k: v for k, v in f.items() if k != "recovery_s"}
                   for f in rs["failovers"]]


def test_engine_requires_sharded_for_replication():
    t = _tables(torch_tables, 60)
    with pytest.raises(ValueError, match="sharded"):
        FeatureEngine(SQL, t, replication=2, device="cpu")
    eng = FeatureEngine(SQL, t, n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="without replication"):
        eng.kill_shard(0)
    assert eng.replication_stats() == {"n_replicas": 0}


def test_engine_kill_heal_bitwise_raw():
    """Kill a shard mid-traffic (rows keep arriving while it is dead),
    heal, serve: bitwise the unsharded engine; lag, stats and the
    promotion record equal the reference's."""
    engines, t = _engines(SQL, ship_every=16)
    a = t["actions"]
    rows = [a.row(i) for i in range(160)]
    _ingest(engines, "actions", rows[:100])
    plain, rep, ref = engines
    info = rep.kill_shard(1)
    assert info == ref.kill_shard(1) and info["shard"] == 1
    _ingest(engines, "actions", rows[100:160])
    recs = rep.heal()
    ref.heal()
    assert len(recs) == 1 and recs[0].shard == 1
    assert recs[0].recovery_s > 0
    _parity(engines, [a.row(200 + i) for i in range(12)])
    stats = rep.replication_stats()
    assert stats["n_replicas"] == 1 and len(stats["failovers"]) == 1
    assert stats["dead_shards"] == []
    _same_stats(rep, ref)


def test_engine_kill_heal_bitwise_preagg():
    """The dead shard's bucket planes are rebuilt from the snapshot
    watermark + a binlog replay through the same sharded fold: bitwise,
    floats included; the recovered planes equal the reference's."""
    engines, t = _engines(PREAGG_SQL, seed=13, use_preagg=True,
                          ship_every=8)
    a = t["actions"]
    rows = [a.row(i) for i in range(150)]
    _ingest(engines, "actions", rows[:90])
    plain, rep, ref = engines
    rep.kill_shard(2)
    ref.kill_shard(2)
    _ingest(engines, "actions", rows[90:150])
    rep.heal()
    ref.heal()
    _parity(engines, [a.row(180 + i) for i in range(8)])
    for lvl in ("fine_epoch", "coarse_epoch"):
        np.testing.assert_array_equal(rep.pre_states[0][lvl].numpy(),
                                      np.asarray(ref.pre_states[0][lvl]))
    for k, v in ref.pre_states[0]["fine"].items():
        got = rep.pre_states[0]["fine"][k].numpy()
        if k.startswith("ew"):
            np.testing.assert_allclose(got, np.asarray(v), rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    _same_stats(rep, ref)


def test_engine_kill_all_shards_then_heal():
    engines, t = _engines(SQL, n=160, seed=17, reference=False)
    a = t["actions"]
    _ingest(engines, "actions", [a.row(i) for i in range(120)])
    rep = engines[1]
    for s in range(4):
        rep.kill_shard(s)
    assert rep.replication_stats()["dead_shards"] == [0, 1, 2, 3]
    recs = rep.heal()
    assert sorted(r.shard for r in recs) == [0, 1, 2, 3]
    _parity(engines, [a.row(130 + i) for i in range(10)])


def test_engine_retention_eviction_is_replication_barrier():
    """Scheduled evict + compact ticks run between kill and heal: the
    followers ship, then evict with the leader's horizon, so promotion
    stays bitwise after rows were dropped on both sides."""
    engines, t = _engines(SQL, n=300, seed=19, horizon=60_000,
                          retention="auto", compact_every=64,
                          ship_every=16)
    a = t["actions"]
    rows = [a.row(i) for i in range(260)]
    for lo in range(0, 200, 40):
        _ingest(engines, "actions", rows[lo:lo + 40])
    plain, rep, ref = engines
    assert rep.store.n_rows("actions") == ref.store.n_rows("actions")
    rep.kill_shard(0)
    ref.kill_shard(0)
    _ingest(engines, "actions", rows[200:260])
    rep.heal()
    ref.heal()
    _parity(engines, [a.row(270 + i) for i in range(8)])
    _same_stats(rep, ref)
    assert rep.store._binlog_base == ref.store._binlog_base


def test_engine_bulk_load_is_snapshot_barrier():
    """``bulk_load`` re-cuts the recovery snapshot and re-seeds the
    followers, so a later kill + heal never replays across the load."""
    engines, t = _engines(PREAGG_SQL, n=200, seed=23, use_preagg=True,
                          ship_every=8, reference=False)
    for e in engines[:2]:
        e.bulk_load("actions", t["actions"])
    rep = engines[1]
    assert rep.replication_stats()["snapshot_watermark"] == \
        rep.store._binlog_offset
    a = t["actions"]
    extra = [dict(a.row(i), ts=int(a.row(i)["ts"]) + 10_000_000)
             for i in range(40)]
    _ingest(engines, "actions", extra)
    rep.kill_shard(3)
    rep.heal()
    _parity(engines, [a.row(60 + i) for i in range(8)])


def test_engine_checkpoint_to_disk_and_watermark(tmp_path):
    t = _tables(torch_tables, n=120, seed=29)
    rep = FeatureEngine(SQL, t, capacity=1024, n_shards=4, replication=1,
                        checkpoint_dir=str(tmp_path), device="cpu")
    a = t["actions"]
    rep.ingest_many("actions", [a.row(i) for i in range(80)])
    wm = rep.checkpoint()
    assert wm == rep.store._binlog_offset
    assert rep.ckpt.latest_step() == wm
    restored = rep.ckpt.restore({"tables": dict(rep.store.tables),
                                 "pre": rep.pre_states})
    for name, st in rep.store.tables.items():
        assert torch.equal(restored["tables"][name]["count"], st["count"])
        assert torch.equal(restored["tables"][name]["cols"]["price"],
                           st["cols"]["price"])


def test_verify_consistency_with_failover_raw():
    """Offline (never faulted) against a sharded replay that kills and
    fails over the owner shard of request 5: bitwise."""
    t = _tables(torch_tables, n=140, seed=31)
    cs = compile_script(SQL, tables=t)
    rpt = verify_consistency(cs, t, n_shards=4, bitwise=True, replication=1,
                             kill_shard_at=5, ship_every=7, device="cpu")
    assert rpt.passed and rpt.bitwise_equal, str(rpt)


def test_verify_consistency_with_failover_preagg():
    t = _tables(torch_tables, n=100, seed=33)
    cs = compile_script(PREAGG_SQL, tables=t)
    rpt = verify_consistency(cs, t, use_preagg=True, n_shards=3,
                             replication=2, kill_shard_at=40, ship_every=5,
                             device="cpu")
    assert rpt.passed, str(rpt)


def test_verify_consistency_failover_needs_replication():
    t = _tables(torch_tables, n=40, seed=37)
    cs = compile_script(SQL, tables=t)
    with pytest.raises(ValueError, match="replication"):
        verify_consistency(cs, t, n_shards=4, kill_shard_at=3,
                           device="cpu")


# -------------------------------------- rebalance two-phase fault injection


def test_rebalance_crash_between_build_and_commit(monkeypatch):
    """A crash after migrated states are built but before the commit
    leaves serving unchanged: no partly migrated table, the old
    assignment; a retry succeeds."""
    tt = torch_tables(n_actions=400, n_orders=0, n_users=12,
                      horizon_ms=120_000, zipf_alpha=1.3, seed=1,
                      with_profile=False)
    sql = SQL.replace("min(price) OVER w AS mn, max(price) OVER w AS mx",
                      "max(price) OVER w AS mx")
    eng = FeatureEngine(sql, tt, capacity=1024, n_shards=4, device="cpu")
    a = tt["actions"]
    eng.ingest_many("actions", [a.row(i) for i in range(200)])
    probe = [dict(a.row(250 + i)) for i in range(10)]
    before = eng.request_batch(probe)
    store = eng.store
    assign_before = store.assignment.copy()
    real = ShardedOnlineStore._build_state

    def crashing(self, *args, **kw):
        raise RuntimeError("injected crash before commit")

    monkeypatch.setattr(ShardedOnlineStore, "_build_state", crashing)
    with pytest.raises(RuntimeError, match="injected crash"):
        eng.rebalance()
    monkeypatch.setattr(ShardedOnlineStore, "_build_state", real)
    np.testing.assert_array_equal(store.assignment, assign_before)
    after = eng.request_batch(probe)
    for b, c in zip(before, after):
        for k in b:
            np.testing.assert_array_equal(b[k], c[k])
    eng.ingest_many("actions", [a.row(200 + i) for i in range(30)])
    assert eng.rebalance()
    retry = eng.request_batch(probe)
    for b, c in zip(before, retry):
        for k in b:
            assert c[k].shape == b[k].shape
