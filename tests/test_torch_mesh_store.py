"""The key-sharded store and engine on a device mesh, port against
reference: ``ShardedOnlineStore`` / ``FeatureEngine`` / ``offline_sharded``
with ``mesh=`` a ``Mesh`` of four CPU entries
(one shard's state per entry), against the port's stacked ``n_shards=4``
engine (bitwise) and the reference's ``n_shards=4`` engine (bitwise,
``ew`` at ``EW_RTOL`` / ``EW_ATOL``).  The reference's own ``mesh=``
tests are red on the CPU, so its stacked path is the oracle.  Replicas,
the consistency gate and rebalance on the mesh are in
``test_torch_mesh_replicas.py``.

Every shard's tensors (store tables, pre-agg planes, follower replicas)
are checked to sit on the device its mesh entry names, and followers on
the entry ``(s + 1 + r) % 4`` (entries are told apart by identity: on
the CPU they all name one device).
"""

import types

import numpy as np
import pytest
import torch

from repro.data.synthetic import make_action_tables as jax_tables
from repro.serve.engine import FeatureEngine as JaxEngine
from repro.storage.timestore import ShardedOnlineStore as JaxStore
from repro_torch.core import compile_script
from repro_torch.core.types import Table
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.distributed.sharding import Mesh, key_shard_mesh
from repro_torch.serve.engine import FeatureEngine
from repro_torch.storage.timestore import ShardedOnlineStore

from torch_port_cases import ACTION_TABLES, EW_ATOL, EW_RTOL, SMOKE_SQL

CPU = torch.device("cpu")
N = 4
PREAGG_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       min(price) OVER w AS mn, max(price) OVER w AS mx,
       ew_avg(price, 0.5) OVER w AS ew
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 30s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "w:10s")
"""
# the staged path against the reference: a UNION window and a ROWS window
# over the additive, max and EW families (a script the reference
# compiles in seconds per batch class)
UNION_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       max(price) OVER w AS mx, ew_avg(price, 0.5) OVER wr AS ew
FROM actions
WINDOW w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW),
  wr AS (PARTITION BY userid ORDER BY ts
         ROWS BETWEEN 100 PRECEDING AND CURRENT ROW)
"""
SKEWED_TABLES = dict(n_actions=400, n_orders=0, n_users=12,
                     horizon_ms=120_000, zipf_alpha=1.3, seed=1,
                     with_profile=False)


def _mesh():
    return key_shard_mesh(N, devices=[CPU] * N)


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


def _assert_placed(eng, mesh):
    """Every shard's tables and planes: a one-shard state on its mesh
    device; every follower on the entry (s + 1 + r) % N."""
    store = eng.store
    entries = list(mesh.devices.flat)
    assert store.mesh is mesh and store.devices == entries
    for t, parts in store.tables.items():
        assert isinstance(parts, tuple) and len(parts) == N
        for s, st in enumerate(parts):
            leaves = [st["keys"], st["ts"], st["count"], st["comp"],
                      *st["cols"].values()]
            assert all(x.shape[0] == 1 and x.device == entries[s]
                       for x in leaves), (t, s)
    for wi, parts in (eng.pre_states or {}).items():
        assert isinstance(parts, tuple) and len(parts) == N
        for s, st in enumerate(parts):
            for lvl in ("fine", "coarse"):
                for x in [*st[lvl].values(), st[f"{lvl}_epoch"]]:
                    assert x.shape[0] == 1 and x.device == entries[s]
    if eng.repl is not None:
        for (s, r), f in eng.repl.followers.items():
            assert f.device is entries[(s + 1 + r) % N]
            for st in f.tables.values():
                assert st["keys"].device == f.device


def _engines(sql, tkw, n_ingest, load=("actions",), capacity=1024,
             reference=True, **opts):
    """(mesh engine, stacked n_shards=N engine, reference n_shards=N
    engine or None) fed identical ``ingest_many`` batches."""
    tt = torch_tables(**tkw)
    mesh = _mesh()
    engines = [FeatureEngine(sql, tt, capacity=capacity, mesh=mesh, **opts),
               FeatureEngine(sql, tt, capacity=capacity, n_shards=N,
                             device="cpu", **opts)]
    if reference:
        engines.append(JaxEngine(sql, jax_tables(**tkw), capacity=capacity,
                                 n_shards=N, **{k: v for k, v in opts.items()
                                                if k != "replication"}))
    for tname in load:
        t = tt[tname]
        rows = [t.row(i) for i in range(min(n_ingest, len(t)))]
        for e in engines:
            e.ingest_many(tname, rows)
    return (engines + [None])[:3], tt, mesh


def _parity(engines, rows):
    got = engines[0].request_batch([dict(r) for r in rows])
    _assert_feats(got, engines[1].request_batch([dict(r) for r in rows]),
                  loose=False)
    if engines[2] is not None:
        _assert_feats(got, engines[2].request_batch([dict(r) for r in rows]))
    return got


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_mesh_serving_equals_stacked_and_reference(fused):
    """B = 1 / 8 / 64 over a UNION of both tables, staged against the
    reference too, fused (the smoke script, the chip's path) against the
    port's stacked engine; the stores hold the same rows per shard, slice
    for slice, as the stacked store and the reference's."""
    sql = SMOKE_SQL if fused else UNION_SQL
    engines, tt, mesh = _engines(sql, ACTION_TABLES, 120,
                                 load=("orders", "actions"),
                                 fused_fold=fused, reference=not fused)
    a = tt["actions"]
    for b in (1, 8, 64):
        _parity(engines, [a.row((150 + 3 * i) % 300) for i in range(b)])
    _assert_placed(engines[0], mesh)
    port, stacked, ref = engines
    for t in ("actions", "orders"):
        np.testing.assert_array_equal(port.store.n_rows_per_shard(t),
                                      stacked.store.n_rows_per_shard(t))
        for s in range(N):
            got = port.store.shard_state(t, s)
            want = stacked.store.shard_state(t, s)
            for k in ("keys", "ts", "count", "comp"):
                assert torch.equal(got[k], want[k]), (t, s, k)
            if ref is not None:
                np.testing.assert_array_equal(
                    got["keys"].numpy(), np.asarray(ref.store.tables[t][
                        "keys"][s]))


def test_mesh_offline_and_offline_sharded_equal_offline():
    tt = torch_tables(**ACTION_TABLES)
    eng = FeatureEngine(SMOKE_SQL, tt, capacity=1024, mesh=_mesh(),
                        fused_fold=True)
    want = compile_script(SMOKE_SQL, tables=tt).offline(tt, device="cpu")
    for got in (eng.offline(),
                eng.cs.offline_sharded(tt, mesh=_mesh()),
                eng.cs.offline_sharded(tt, mesh=key_shard_mesh(
                    3, devices=[CPU] * 3))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mesh_long_window_planes_bulk_load_and_snapshot():
    """The pre-agg path on a mesh: planes folded at bulk load and ingest
    equal the stacked engine's plane for plane; a snapshot keeps its
    bytes across later ingest."""
    tkw = dict(n_actions=200, n_orders=0, n_users=4,
               horizon_ms=12_000_000, seed=4, with_profile=False)
    tt = torch_tables(**tkw)
    a = tt["actions"]
    mesh = _mesh()
    sql = PREAGG_SQL.replace("30s", "3000s").replace("w:10s", "w:100s")
    eng = FeatureEngine(sql, tt, capacity=512, use_preagg=True, mesh=mesh)
    stacked = FeatureEngine(sql, tt, capacity=512, use_preagg=True,
                            n_shards=N, device="cpu")
    head = Table(a.schema, {c: v[:120] for c, v in a.columns.items()},
                 dicts=a.dicts)
    for e in (eng, stacked):
        e.bulk_load("actions", head)
        e.ingest_many("actions", [a.row(i) for i in range(120, 160)])
    probe = [dict(a.row(170 + i)) for i in range(4)]
    snap = eng.snapshot()
    before = eng.request_batch(probe, snapshot=snap)
    _assert_feats(before, stacked.request_batch(probe), loose=False)
    for lvl in ("fine", "coarse"):
        for k, v in stacked.pre_states[0][lvl].items():
            got = torch.cat([p[lvl][k] for p in eng.pre_states[0]])
            assert torch.equal(got, v), (lvl, k)
    _assert_placed(eng, mesh)
    eng.ingest_many("actions", [a.row(i) for i in range(160, 170)])
    _assert_feats(eng.request_batch(probe, snapshot=snap), before,
                  loose=False)
    assert isinstance(snap.store.tables["actions"], tuple)


def test_mesh_options_raise_as_the_references(micro_sql):
    mesh = _mesh()
    stand_in = types.SimpleNamespace(shape={"shard": N})
    for kw in ({"n_shards": 3}, {"axis": "model"}):
        with pytest.raises(ValueError) as want:
            JaxStore(64, mesh=stand_in, **kw)
        with pytest.raises(ValueError) as got:
            ShardedOnlineStore(64, mesh=mesh, **kw)
        assert str(got.value) == str(want.value)
    tt = torch_tables(**ACTION_TABLES)
    with pytest.raises(ValueError, match="n_shards=3 != mesh axis"):
        FeatureEngine(micro_sql, tt, capacity=64, mesh=mesh, n_shards=3)
    with pytest.raises(ValueError, match="no axis 'shard'"):
        FeatureEngine(micro_sql, tt, capacity=64,
                      mesh=Mesh([CPU, CPU], ("model",)))
    cs = compile_script(micro_sql, tables=tt)
    with pytest.raises(ValueError, match="n_shards=2 != mesh axis"):
        cs.offline_sharded(tt, mesh=mesh, n_shards=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FeatureEngine(micro_sql, tt, capacity=64,
                          mesh=Mesh(["cuda"] * 2, ("shard",)))
