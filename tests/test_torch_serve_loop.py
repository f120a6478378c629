"""The serving loop, port against reference: ``ServeLoop``, ``VirtualClock``,
``EngineSnapshot`` and record/replay (``serve.trace``) in both packages
on the same numpy-seeded tables and stimuli.

* Traces: one stimulus list (requests with and without deadlines, ingest
  batches of both tables, steps, forced flushes, drains; a bounded queue
  that sheds) replayed through each package's loop under a service model
  gives equal ``stats``, shed decisions, result ids, latencies and
  feature bytes (bitwise; ``ew`` and ``dd`` at ``EW_RTOL``), for a
  fused, a staged and a ``use_preagg`` engine with retention; a trace
  saved by the reference's ``save_trace`` replays through the port.
* Snapshots: isolation across ``ingest_many`` + compaction, in bytes,
  pre-agg planes included; the per-(store, pad class) cache stays
  bounded across swaps; ``store_state_arrays`` equals the reference's.
* Loop behaviour: deadline vs count-only flushes, shedding,
  backpressure, SLO misses, the statistics' edge cases (each scenario
  runs in both packages and must observe the same).
* The gate: ``record_consistency_trace`` + ``verify_consistency(
  bitwise=True, online_outputs=...)``.
"""

import types

import numpy as np
import pytest
import torch

from repro.core import compile_script as jax_compile
from repro.data.synthetic import make_action_tables as jax_tables
from repro.serve import AdmissionError as JaxAdmission
from repro.serve import FeatureEngine as JaxEngine
from repro.serve import ServeLoop as JaxLoop
from repro.serve import VirtualClock as JaxClock
from repro.serve import trace as jax_trace
from repro_torch.core import verify_consistency
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.serve import AdmissionError, FeatureEngine, ServeLoop, \
    VirtualClock
from repro_torch.serve import trace as torch_trace

from torch_port_cases import EW_ATOL, EW_RTOL, SMOKE_SQL

# the reference's tests/test_serve_loop.py RAW_SQL
RAW_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       max(price) OVER w AS mx, min(price) OVER w AS mn
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 10s PRECEDING AND CURRENT ROW)
"""

# tests/test_torch_preagg.py's PREAGG_SQL (a long window over 3,000 s)
PREAGG_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       min(price) OVER w AS mn, max(price) OVER w AS mx,
       ew_avg(price, 0.5) OVER w AS ew
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 3000s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "w:100s")
"""

LOOP_TABLES = dict(n_actions=60, n_orders=0, n_users=4, horizon_ms=600_000,
                   seed=3, with_profile=False)

# engine kind -> (script, tables, engine options)
KINDS = {
    "fused": (SMOKE_SQL, dict(n_actions=150, n_orders=100, n_users=4,
                              horizon_ms=300_000, seed=5,
                              with_profile=False),
              dict(fused_fold=True, retention="auto", compact_every=16)),
    "staged": (SMOKE_SQL, dict(n_actions=150, n_orders=100, n_users=4,
                               horizon_ms=300_000, seed=6,
                               with_profile=False),
               dict(fused_fold=False, retention="auto", compact_every=16)),
    "preagg": (PREAGG_SQL, dict(n_actions=160, n_orders=0, n_users=4,
                                horizon_ms=12_000_000, seed=4,
                                with_profile=False),
               dict(use_preagg=True, retention="auto", compact_every=24)),
}
LOOSE = ("ew", "dd")
LOOP_KW = dict(batch_size=4, max_wait_ms=2.0, slo_ms=6.0, max_queue=6,
               ingest_queue_rows=12)


def _service_ms(n: int) -> float:
    return 0.8 + 0.25 * n


PKG = {
    "reference": types.SimpleNamespace(
        Engine=JaxEngine, Loop=JaxLoop, Clock=JaxClock,
        Admission=JaxAdmission, tables=jax_tables, trace=jax_trace, kw={}),
    "port": types.SimpleNamespace(
        Engine=FeatureEngine, Loop=ServeLoop, Clock=VirtualClock,
        Admission=AdmissionError, tables=torch_tables, trace=torch_trace,
        kw={"device": "cpu"}),
}


def _int_prices(tables):
    for t in tables.values():
        if "price" in t.columns:
            t.columns["price"] = np.floor(t.columns["price"]).astype(
                np.float32)
    return tables


def _plain(row):
    return {k: (v.item() if isinstance(v, np.generic) else v)
            for k, v in row.items()}


def _stimuli(tables, seed, n_events=90):
    """A mixed stimulus list (trace JSON): a drained history, then
    requests (some with a tight deadline), ingest batches of one table
    each in time order, steps, forced flushes and drains, at
    exponentially spaced clock times."""
    rng = np.random.default_rng(seed)
    stream = sorted((int(t.columns["ts"][i]), name, i)
                    for name, t in tables.items()
                    for i in range(len(t)))
    n_hist = len(stream) // 3
    ev = []
    for name in tables:
        rows = [_plain(tables[name].row(i)) for _, n, i in stream[:n_hist]
                if n == name]
        if rows:
            ev.append({"op": "ingest", "t": 0.0, "table": name,
                       "rows": rows})
    ev.append({"op": "drain", "t": 0.0})
    pos, t = n_hist, 0.0
    acts = [i for _, n, i in stream if n == "actions"]
    # a burst past the queue bound: the last requests shed
    ev += [{"op": "request", "t": 0.0,
            "row": _plain(tables["actions"].row(acts[-1 - k]))}
           for k in range(LOOP_KW["max_queue"] + 2)]
    for _ in range(n_events):
        t += float(rng.exponential(1.5e-3))
        u = rng.random()
        if u < 0.45:
            i = acts[min(len(acts) - 1, int(rng.integers(
                len(acts) // 3, len(acts))))]
            e = {"op": "request", "t": t,
                 "row": _plain(tables["actions"].row(i))}
            if rng.random() < 0.2:
                e["deadline_ms"] = 1.0
            ev.append(e)
        elif u < 0.7 and pos < len(stream):
            name = stream[pos][1]
            rows = []
            while (pos < len(stream) and stream[pos][1] == name
                   and len(rows) < int(rng.integers(1, 7))):
                rows.append(_plain(tables[name].row(stream[pos][2])))
                pos += 1
            ev.append({"op": "ingest", "t": t, "table": name, "rows": rows})
        elif u < 0.95:
            ev.append({"op": "step", "t": t})
        elif u < 0.98:
            ev.append({"op": "flush", "t": t})
        else:
            ev.append({"op": "drain", "t": t})
    return ev


def _replay_both(kind, events_json=None, seed=0):
    sql, tkw, ekw = KINDS[kind]
    loops = {}
    for name, pkg in PKG.items():
        tables = pkg.tables(**tkw)
        if events_json is None:
            events_json = _stimuli(tables, seed)
        events = [pkg.trace.TraceEvent.from_json(d) for d in events_json]
        loop = pkg.trace.replay(
            events, lambda: pkg.Engine(sql, tables, capacity=512,
                                       **ekw, **pkg.kw),
            service_model=_service_ms, **LOOP_KW)
        loop.run_until_idle()
        loops[name] = loop
    return loops["reference"], loops["port"]


def _assert_results(got, want):
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        assert set(g) == set(w), rid
        for k in w:
            a, b = np.asarray(w[k]), np.asarray(g[k])
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if k.startswith(LOOSE):
                np.testing.assert_allclose(b, a, rtol=EW_RTOL, atol=EW_ATOL,
                                           err_msg=f"{rid}/{k}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{rid}/{k}")


def _ref_label(path: str) -> str:
    """``['actions']['cols']['price']`` -> ``actions/cols/price``."""
    return "/".join(p.strip("'\"") for p in path.strip("[]").split("]["))


def _assert_store_arrays(port_eng, ref_eng):
    got = torch_trace.store_state_arrays(port_eng)
    want = jax_trace.store_state_arrays(ref_eng)
    assert [p for p, _ in got] == [_ref_label(p) for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)


# ================================================================== traces


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stimulus_list_replays_alike_in_both_packages(kind):
    ref, port = _replay_both(kind, seed=len(kind))
    assert port.stats == ref.stats
    st = port.stats
    assert st["shed"] > 0 and st["served"] > 0
    assert st["deadline_misses"] > 0 and st["snapshot_swaps"] > 2
    assert st["size_flushes"] + st["deadline_flushes"] > 0
    assert port.latencies == ref.latencies
    assert port.latency_percentiles() == ref.latency_percentiles()
    _assert_results(port.results, ref.results)
    _assert_store_arrays(port.engine, ref.engine)
    # the retention pass ran during the trace
    assert port.engine.store._binlog_base > 0


def test_reference_saved_trace_replays_in_the_port(tmp_path):
    """A trace recorded by the reference's loop and written by its
    ``save_trace`` loads and replays through the port and serves the
    reference's recorded bytes."""
    sql, tkw, ekw = KINDS["fused"]
    jt = jax_tables(**tkw)
    rec = jax_trace.TraceRecorder()
    ref = jax_trace.replay(
        [jax_trace.TraceEvent.from_json(d) for d in _stimuli(jt, 11)],
        lambda: JaxEngine(sql, jt, capacity=512, **ekw), recorder=rec,
        service_model=_service_ms, **LOOP_KW)
    path = str(tmp_path / "reference_trace.json")
    jax_trace.save_trace(rec.events, path)
    tt = torch_tables(**tkw)
    events = torch_trace.load_trace(path)
    assert [e.op for e in events] == [e.op for e in rec.events]
    port = torch_trace.replay(
        events, lambda: FeatureEngine(sql, tt, capacity=512, device="cpu",
                                      **ekw),
        service_model=_service_ms, **LOOP_KW)
    assert port.stats == ref.stats
    _assert_results(port.results, ref.results)
    _assert_store_arrays(port.engine, ref.engine)


def test_trace_json_roundtrip_keeps_events(tmp_path):
    ev = [torch_trace.TraceEvent("request", 0.5,
                                 row={"userid": np.int32(3),
                                      "price": np.float32(1.5)},
                                 deadline_ms=2.0),
          torch_trace.TraceEvent("ingest", 0.75, table="actions",
                                 rows=[{"ts": np.int64(7)}]),
          torch_trace.TraceEvent("step", 1.0)]
    path = str(tmp_path / "t.json")
    torch_trace.save_trace(ev, path)
    back = torch_trace.load_trace(path)
    assert [e.to_json() for e in back] == [e.to_json() for e in ev]
    assert back[0].row == {"userid": 3, "price": 1.5}
    # the reference reads the port's file unchanged
    assert [e.to_json() for e in jax_trace.load_trace(path)] == \
        [e.to_json() for e in ev]
    with pytest.raises(ValueError, match="unknown trace op"):
        torch_trace.replay([torch_trace.TraceEvent("nap", 0.0)],
                           lambda: FeatureEngine(
                               RAW_SQL, torch_tables(**LOOP_TABLES),
                               capacity=64, device="cpu"))


def test_consistency_trace_replay_with_eviction_matches_reference(tmp_path):
    """The reference's recorded consistency trace (integer prices,
    mid-trace eviction) replays through the port: the same outputs in
    base order and the same final store, labels and bits."""
    kw = dict(capacity=256, retention="auto", compact_every=16)
    jt = _int_prices(jax_tables(**LOOP_TABLES))
    tt = _int_prices(torch_tables(**LOOP_TABLES))
    je = JaxEngine(RAW_SQL, jt, **kw)
    jloop, events, rids = jax_trace.record_consistency_trace(je, jt)
    assert je.store.n_rows("actions") < len(jt["actions"])
    path = str(tmp_path / "consistency.json")
    jax_trace.save_trace(events, path)
    rkw = dict(batch_size=1, max_wait_ms=0.0, slo_ms=1e6)
    port = torch_trace.replay(
        torch_trace.load_trace(path),
        lambda: FeatureEngine(RAW_SQL, tt, device="cpu", **kw), **rkw)
    jcs = jax_compile(RAW_SQL, tables=jt)
    want = jax_trace.outputs_in_base_order(jloop, rids, jt, jcs)
    got = torch_trace.outputs_in_base_order(port, rids, tt, port.engine.cs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _assert_store_arrays(port.engine, je)
    assert port.stats == jloop.stats


# =============================================================== snapshots


def _frozen(snap):
    tabs = {t: {k: (v.clone() if k != "cols" else
                    {c: x.clone() for c, x in v.items()})
                for k, v in st.items()}
            for t, st in snap.store.tables.items()}
    pre = ({wi: {lvl: ({k: x.clone() for k, x in p.items()}
                       if isinstance(p, dict) else p.clone())
                 for lvl, p in st.items()}
            for wi, st in snap.pre_states.items()}
           if snap.pre_states is not None else None)
    return tabs, pre


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _tensors(tree[k])
    else:
        yield tree


def _same_bytes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert np.asarray(x[k]).tobytes() == np.asarray(y[k]).tobytes(), k


@pytest.mark.parametrize("kind", ["raw", "preagg"])
def test_snapshot_isolated_from_ingest_and_compaction(kind):
    if kind == "raw":
        sql, tkw = RAW_SQL, LOOP_TABLES
        ekw = dict(fused_fold=True)
    else:
        sql, tkw = PREAGG_SQL, KINDS["preagg"][1]
        ekw = dict(use_preagg=True)
    tt = torch_tables(**tkw)
    a = tt["actions"]
    eng = FeatureEngine(sql, tt, capacity=256, retention="auto",
                        compact_every=8, device="cpu", **ekw)
    eng.ingest_many("actions", [a.row(i) for i in range(40)])
    snap = eng.snapshot()
    frozen_tabs, frozen_pre = _frozen(snap)
    probe = [dict(a.row(i)) for i in range(44, 48)]
    before = eng.request_batch(probe, snapshot=snap)
    n_live = eng.store.n_rows("actions")
    eng.ingest_many("actions", [a.row(i) for i in range(40, len(a))])
    # compaction ran on the live store
    assert eng.store.n_rows("actions") < n_live + len(a) - 40
    after = eng.request_batch(probe, snapshot=snap)
    _same_bytes(before, after)
    for x, y in zip(_tensors(frozen_tabs), _tensors(snap.store.tables)):
        assert torch.equal(x, y)
    if frozen_pre is not None:
        assert snap.pre_states is not eng.pre_states
        for x, y in zip(_tensors(frozen_pre), _tensors(snap.pre_states)):
            assert torch.equal(x, y)
        assert any(not torch.equal(x, y) for x, y in zip(
            _tensors(frozen_pre), _tensors(eng.pre_states)))
    v = snap.version
    assert snap.refresh() == v + 1
    _same_bytes(eng.request_batch(probe, snapshot=snap),
                eng.request_batch(probe))


def test_inflight_requests_not_dirtied_by_ingest():
    """The reference's snapshot-swap gate in the port: requests queued
    before a bulk ingest + compaction serve the bytes of an engine that
    never saw the write (the reference's), and see it after the swap."""
    jt = _int_prices(jax_tables(**LOOP_TABLES))
    tt = _int_prices(torch_tables(**LOOP_TABLES))
    a = tt["actions"]
    history = [a.row(i) for i in range(20)]
    late = [a.row(i) for i in range(20, 50)]
    probe = [dict(a.row(55)), dict(a.row(56))]
    ref = JaxEngine(RAW_SQL, jt, capacity=512)
    ref.ingest_many("actions", history)
    want = ref.request_batch([dict(r) for r in probe])

    eng = FeatureEngine(RAW_SQL, tt, capacity=512, retention="auto",
                        compact_every=8, device="cpu")
    loop = ServeLoop(eng, clock=VirtualClock(), batch_size=2,
                     max_wait_ms=5.0)
    loop.ingest("actions", history)
    loop.drain_ingest()
    rids = [loop.submit(dict(r)) for r in probe]
    loop.ingest("actions", late)
    out = loop.step()                    # requests outrank the ingest
    assert set(out) == set(rids)
    assert loop.stats["ingest_applies"] == 1
    _same_bytes(want, [out[r] for r in rids])
    swaps = loop.stats["snapshot_swaps"]
    loop.run_until_idle()
    assert loop.stats["snapshot_swaps"] == swaps + 1
    ref.ingest_many("actions", late)
    want2 = ref.request_batch([dict(r) for r in probe])
    rids2 = [loop.submit(dict(r)) for r in probe]
    out2 = loop.step()
    _same_bytes(want2, [out2[r] for r in rids2])


def test_snapshot_cache_stays_bounded_across_swaps():
    """Two pad classes (B = 4 and a partial flush padded to 2) give
    exactly two per-(store, pad class) cache entries for the snapshot
    across every swap: a swap re-binds the snapshot's tables, not the
    snapshot."""
    tt = torch_tables(**LOOP_TABLES)
    eng = FeatureEngine(RAW_SQL, tt, capacity=512, fused_fold=True,
                        device="cpu")
    clock = VirtualClock()
    loop = ServeLoop(eng, clock=clock, batch_size=4, max_wait_ms=5.0,
                     slo_ms=50.0)
    a = tt["actions"]
    loop.ingest("actions", [a.row(i) for i in range(20)])
    loop.drain_ingest()
    snap_id = id(loop.snap.store)
    for rnd in range(3):
        for i in range(4):
            loop.submit(dict(a.row(20 + 4 * rnd + i)))
        loop.step()
        loop.submit(dict(a.row(40 + rnd)))
        loop.submit(dict(a.row(44 + rnd)))
        clock.advance(0.0051)
        loop.step()
        loop.ingest("actions", [a.row(47 + rnd)])
        loop.run_until_idle()
    assert loop.stats["snapshot_swaps"] >= 3
    assert id(loop.snap.store) == snap_id
    keys = [k for k in eng.cs._online_fns if k[0] == snap_id]
    assert sorted(k[3] for k in keys) == [2, 4]
    assert len(eng.cs._online_fns) == 2      # the live store never served


# ======================================================== loop behaviour


def _scenario_deadline(pkg):
    tables = pkg.tables(**LOOP_TABLES)
    a = tables["actions"]
    clock = pkg.Clock()
    eng = pkg.Engine(RAW_SQL, tables, capacity=512, **pkg.kw)
    loop = pkg.Loop(eng, clock=clock, slo_ms=50.0, max_wait_ms=5.0,
                    batch_size=4, service_model=lambda n: 1.0)
    loop.ingest("actions", [a.row(i) for i in range(20)])
    loop.drain_ingest()
    r1 = loop.submit(dict(a.row(30)))
    r2 = loop.submit(dict(a.row(31)))
    obs = {"fresh": loop.step()}
    clock.advance(0.0051)
    obs["stale"] = sorted(loop.step())
    rids = [loop.submit(dict(a.row(32))) for _ in range(4)]
    obs["full"] = sorted(loop.step())
    # count-only (no staleness bound): a partial batch waits past
    # max_wait and flushes only at its SLO deadline
    c_loop = pkg.Loop(eng, clock=clock, max_wait_ms=None, batch_size=4,
                      service_model=lambda n: 1.0)
    t_sub = clock.now()
    c_loop.submit(dict(a.row(33)))
    clock.advance(0.02)
    obs["count_only"] = c_loop.step()
    obs["count_only_at"] = c_loop.batcher.next_flush_at() - t_sub
    obs["count_only_idle"] = sorted(c_loop.run_until_idle())
    obs["count_only_clock"] = clock.now() - t_sub
    direct = eng.request_batch([dict(a.row(30))])[0]
    return obs, (loop.stats, c_loop.stats), (r1, r2, rids), (
        loop.results[r1], direct)


def test_deadline_and_count_only_flushes_match_reference():
    got = _scenario_deadline(PKG["port"])
    want = _scenario_deadline(PKG["reference"])
    obs, (stats, c_stats), (r1, r2, rids), (served, direct) = got
    assert obs == want[0] and (stats, c_stats) == want[1]
    assert obs["fresh"] == {} and obs["stale"] == [r1, r2]
    assert obs["full"] == sorted(rids)
    assert stats["deadline_flushes"] == 1 and stats["size_flushes"] == 1
    assert obs["count_only"] == {}
    assert obs["count_only_at"] == pytest.approx(0.025)   # the SLO
    assert obs["count_only_clock"] == pytest.approx(0.026)  # + service
    assert c_stats["deadline_flushes"] == 1 and c_stats["served"] == 1
    _same_bytes([direct], [served])
    _same_bytes([want[3][0]], [served])


def _scenario_admission(pkg):
    tables = pkg.tables(**LOOP_TABLES)
    a = tables["actions"]
    eng = pkg.Engine(RAW_SQL, tables, capacity=512, **pkg.kw)
    # a modelled service time, as the reference's SLO test has: the
    # compared stats then hold no host time (deadline_misses included)
    loop = pkg.Loop(eng, clock=pkg.Clock(), max_queue=3, batch_size=8,
                    service_model=lambda n: 2.0)
    rids = [loop.submit(dict(a.row(i))) for i in range(3)]
    n_before = eng.n_requests
    with pytest.raises(pkg.Admission) as ei:
        loop.submit(dict(a.row(3)))
    out = loop.run_until_idle()
    return {"queued": ei.value.queued, "max_queue": ei.value.max_queue,
            "served_ids": sorted(out), "rids": rids,
            "computed": eng.n_requests - n_before, "stats": loop.stats}


def test_admission_sheds_like_the_reference():
    got = _scenario_admission(PKG["port"])
    assert got == _scenario_admission(PKG["reference"])
    assert got["queued"] == 3 and got["max_queue"] == 3
    assert got["served_ids"] == got["rids"] and got["computed"] == 3
    assert got["stats"]["shed"] == 1 and got["stats"]["served"] == 3


def _scenario_backpressure(pkg):
    tables = pkg.tables(**LOOP_TABLES)
    a = tables["actions"]
    eng = pkg.Engine(RAW_SQL, tables, capacity=512, **pkg.kw)
    loop = pkg.Loop(eng, clock=pkg.Clock(), ingest_queue_rows=16)
    loop.ingest("actions", [a.row(i) for i in range(10)])
    applied_before = loop.stats["ingest_applies"]
    loop.ingest("actions", [a.row(i) for i in range(10, 30)])
    return {"applied_before": applied_before, "stats": dict(loop.stats),
            "queued_rows": loop._ingest_q_rows,
            "stored": eng.store.n_rows("actions")}


def test_ingest_backpressure_matches_reference():
    got = _scenario_backpressure(PKG["port"])
    assert got == _scenario_backpressure(PKG["reference"])
    assert got["applied_before"] == 0
    assert got["stats"]["backpressure_applies"] >= 1
    assert got["queued_rows"] <= 16 and got["stored"] >= 10


def _scenario_slo(pkg):
    tables = pkg.tables(**LOOP_TABLES)
    a = tables["actions"]
    clock = pkg.Clock()
    eng = pkg.Engine(RAW_SQL, tables, capacity=512, **pkg.kw)
    loop = pkg.Loop(eng, clock=clock, slo_ms=10.0, max_wait_ms=5.0,
                    batch_size=4, service_model=lambda n: 2.0)
    loop.submit(dict(a.row(0)))             # deadline at t = 10 ms
    clock.advance(0.009)
    loop.step()                             # 9 ms + 2 ms service = 11 ms
    first = (loop.stats["deadline_misses"], loop.latency_percentiles())
    loop.submit(dict(a.row(1)), deadline_ms=20.0)
    clock.advance(0.006)
    loop.step()                             # 6 + 2 = 8 ms < 20 ms
    return first, loop.stats["deadline_misses"], \
        loop.latency_percentiles(), clock.now()


def test_slo_miss_accounting_matches_reference():
    got = _scenario_slo(PKG["port"])
    assert got == _scenario_slo(PKG["reference"])
    (misses, pct), misses2, pct2, _ = got
    assert misses == 1 and pct["TP50"] == pytest.approx(11.0)
    assert misses2 == 1 and pct2["max_ms"] == pytest.approx(11.0)
    assert set(pct2) == {"TP50", "TP99", "TP999", "max_ms"}


def _scenario_stats(pkg):
    tables = pkg.tables(**LOOP_TABLES)
    a = tables["actions"]
    eng = pkg.Engine(RAW_SQL, tables, capacity=512, latency_window=8,
                     **pkg.kw)
    obs = {"empty": (eng.latency_percentiles(), eng.ingest_stats())}
    eng.ingest_many("actions", [a.row(i) for i in range(25)])
    eng.ingest("actions", a.row(25))
    ist = eng.ingest_stats()
    obs["ingest"] = (eng.latency_percentiles(), ist["rows"], ist["calls"],
                     ist["TP99"] >= ist["TP50"] > 0, sorted(ist))
    for _ in range(3):
        eng.request_batch([dict(a.row(i)) for i in range(4)])
    obs["bounded"] = (len(eng.latencies_ms), len(eng.ingest_ms) <= 8,
                      sorted(eng.latency_percentiles()),
                      len(set(list(eng.latencies_ms)[-4:])))
    loop = pkg.Loop(eng, clock=pkg.Clock())
    obs["loop_empty"] = loop.latency_percentiles()
    eng.reset_stats()
    obs["reset"] = (eng.latency_percentiles(), eng.ingest_stats(),
                    eng.rows_ingested, eng.n_requests)
    return obs


def test_stats_edge_cases_match_reference():
    got = _scenario_stats(PKG["port"])
    assert got == _scenario_stats(PKG["reference"])
    assert got["empty"] == ({}, {})
    assert got["ingest"][:3] == ({}, 26.0, 2.0) and got["ingest"][3]
    assert got["bounded"] == (8, True, ["TP50", "TP90", "TP95", "TP99"], 1)
    assert got["loop_empty"] == {} and got["reset"] == ({}, {}, 0, 0)


def test_loop_defaults_to_the_card():
    """The loop runs on whatever engine it is given; the engine's default
    device is the card, which raises here without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(FeatureEngine(RAW_SQL, torch_tables(**LOOP_TABLES),
                                capacity=64, retention="auto"))


def test_preagg_init_state_defaults_to_the_card():
    cs = FeatureEngine(PREAGG_SQL, torch_tables(**KINDS["preagg"][1]),
                       capacity=64, use_preagg=True, device="cpu").cs
    pa = cs.windows[0].preagg
    st = pa.init_state(device="cpu")
    assert st["fine_epoch"].device.type == "cpu"
    if torch.cuda.is_available():
        assert pa.init_state()["fine_epoch"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pa.init_state()


# ==================================================================== gate


@pytest.mark.parametrize("sql", ["raw", "smoke"])
def test_consistency_gate_through_the_loop(sql, tmp_path):
    """The loop-driven interleaving, with mid-trace eviction, holds the
    bitwise gate against ``offline()``, and two replays of its saved
    trace give the same outputs and final store."""
    text = RAW_SQL if sql == "raw" else SMOKE_SQL
    tkw = (LOOP_TABLES if sql == "raw" else dict(
        n_actions=80, n_orders=60, n_users=4, horizon_ms=300_000, seed=8,
        with_profile=False))
    tt = _int_prices(torch_tables(**tkw))

    def factory():
        return FeatureEngine(text, tt, capacity=256, retention="auto",
                             compact_every=16, fused_fold=True, device="cpu")

    eng = factory()
    loop, events, rids = torch_trace.record_consistency_trace(eng, tt)
    evicted = sum(len(t) for n, t in tt.items() if n in eng._need) - sum(
        eng.store.n_rows(n) for n in eng._need)
    assert evicted > 0
    cs = eng.cs
    out = torch_trace.outputs_in_base_order(loop, rids, tt, cs)
    rep = verify_consistency(cs, tt, bitwise=True, online_outputs=out,
                             device="cpu")
    assert rep.passed and rep.bitwise_equal, str(rep)
    path = str(tmp_path / "trace.json")
    torch_trace.save_trace(events, path)
    kw = dict(batch_size=1, max_wait_ms=0.0, slo_ms=1e6)
    lp1 = torch_trace.replay(torch_trace.load_trace(path), factory, **kw)
    lp2 = torch_trace.replay(torch_trace.load_trace(path), factory, **kw)
    o1 = torch_trace.outputs_in_base_order(lp1, rids, tt, cs)
    o2 = torch_trace.outputs_in_base_order(lp2, rids, tt, cs)
    for k in out:
        np.testing.assert_array_equal(o1[k], out[k], err_msg=k)
        np.testing.assert_array_equal(o2[k], o1[k], err_msg=k)
    for (pa, xa), (pb, xb) in zip(torch_trace.store_state_arrays(lp1.engine),
                                  torch_trace.store_state_arrays(lp2.engine)):
        assert pa == pb
        np.testing.assert_array_equal(xa, xb, err_msg=pa)
