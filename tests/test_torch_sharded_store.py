"""The key-sharded store and its pre-agg planes, port against reference
(the reference's stacked ``mesh=None`` layout) on the same numpy-seeded
rows: routing, ``put_many`` / ``bulk_load`` / ``evict`` / ``rebalance``
/ ``wipe_shard`` / ``install_shard``, the binlog, the two-phase
rebalance, snapshot isolation of the stacked tensors, and the stacked
pre-agg planes after ``update_many_sharded``, ``migrate_state_sharded``
and ``restore_shard_plane``.  Store states must be equal shard by shard
(``keys``, ``ts``, ``count`` and every column), routing array for array,
planes bitwise (drawdown and EW at the plane bar of
``test_torch_preagg``)."""

import jax
import numpy as np
import pytest
import torch

from repro.storage.timestore import ShardedOnlineStore as JaxStore
from repro_torch.core import compile_script, verify_consistency
from repro_torch.data.synthetic import make_action_tables
from repro_torch.distributed.sharding import Mesh
from repro_torch.serve.engine import FeatureEngine
from repro_torch.storage.timestore import ShardedOnlineStore, composite

from test_torch_preagg import _assert_planes, _pair, _rows

SPECS = {"v": np.float32, "q": np.int32}


def _stores(n_shards=4, capacity=128):
    out = []
    for st in (ShardedOnlineStore(capacity=capacity, n_shards=n_shards,
                                  device="cpu"),
               JaxStore(capacity=capacity, n_shards=n_shards)):
        st.create_table("t", dict(SPECS))
        out.append(st)
    return out


def _batch(rng, n, n_keys=16, t_hi=1000):
    keys = rng.integers(0, n_keys, n).astype(np.int32)
    ts = rng.integers(0, t_hi, n).astype(np.int32)
    return keys, ts, {"v": rng.normal(size=n).astype(np.float32),
                      "q": rng.integers(0, 5, n).astype(np.float32)}


def _assert_state(port, ref, table="t"):
    a = jax.device_get(ref.tables[table])
    b = port.tables[table]
    for k in ("keys", "ts", "count"):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]),
                                      err_msg=k)
    for c in a["cols"]:
        np.testing.assert_array_equal(b["cols"][c].numpy(),
                                      np.asarray(a["cols"][c]), err_msg=c)
    # the derived composite stays in step with keys and ts
    assert torch.equal(b["comp"], composite(b["keys"], b["ts"]))


def test_routing_is_total_stable_and_equals_reference():
    port, ref = _stores()
    keys = np.arange(-50, 1000)
    owner = port.owner_of_keys(keys)
    assert owner.min() >= 0 and owner.max() < 4
    np.testing.assert_array_equal(owner, port.owner_of_keys(keys))
    np.testing.assert_array_equal(owner, ref.owner_of_keys(keys))
    np.testing.assert_array_equal(port.route_slots(keys),
                                  ref.route_slots(keys))


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_put_many_equals_reference(n_shards):
    """Several routed batches (repeated (key, ts) peers included): each
    shard keeps the reference's (key, ts, arrival) order."""
    port, ref = _stores(n_shards=n_shards, capacity=256)
    rng = np.random.default_rng(n_shards)
    for n in (37, 1, 60):
        keys, ts, cols = _batch(rng, n, t_hi=40)
        assert port.put_many("t", keys, ts, cols) == \
            ref.put_many("t", keys, ts, cols)
        _assert_state(port, ref)
    assert port.binlog == ref.binlog
    np.testing.assert_array_equal(port._slot_counts, ref._slot_counts)
    np.testing.assert_array_equal(port.n_rows_per_shard("t"),
                                  ref.n_rows_per_shard("t"))


def test_put_and_bulk_load_agree():
    rng = np.random.default_rng(0)
    keys, ts, cols = _batch(rng, 40)
    ts = np.sort(ts)
    a, ref = _stores()
    b, _ = _stores()
    a.put_many("t", keys, ts, cols)
    b.bulk_load("t", keys, ts, cols)
    ref.bulk_load("t", keys, ts, cols)
    for k in ("keys", "ts", "count"):
        assert torch.equal(a.tables["t"][k], b.tables["t"][k])
    assert torch.equal(a.tables["t"]["cols"]["v"],
                       b.tables["t"]["cols"]["v"])
    _assert_state(b, ref)
    assert b.binlog == ref.binlog


def test_per_shard_overflow():
    st = ShardedOnlineStore(capacity=4, n_shards=2, device="cpu")
    st.create_table("t", {"v": np.float32})
    keys = np.zeros(6, np.int32)   # one key -> one shard -> overflow
    with pytest.raises(ValueError, match="overflows shard"):
        st.put_many("t", keys, np.arange(6, dtype=np.int32),
                    {"v": np.zeros(6, np.float32)})
    with pytest.raises(ValueError, match="per-shard capacity"):
        st.bulk_load("t", keys, np.arange(6, dtype=np.int32),
                     {"v": np.zeros(6, np.float32)})
    assert st.n_rows("t") == 0 and not st._slot_counts.any()


def test_evict_rebalance_wipe_equal_reference():
    port, ref = _stores(capacity=256)
    rng = np.random.default_rng(5)
    for _ in range(3):
        keys, ts, cols = _batch(rng, 50)
        keys[:20] = 3                                  # a hot key
        for st in (port, ref):
            st.put_many("t", keys, ts, cols)
    for st in (port, ref):
        st.evict("t", 300)
    _assert_state(port, ref)
    assert port.rebalance() and ref.rebalance()
    np.testing.assert_array_equal(port.assignment, ref.assignment)
    np.testing.assert_array_equal(port.balancer.load, ref.balancer.load)
    _assert_state(port, ref)
    assert port.n_rebalances == ref.n_rebalances == 1
    keys, ts, cols = _batch(rng, 30)
    for st in (port, ref):                  # routed by the new assignment
        st.put_many("t", keys, ts, cols)
    _assert_state(port, ref)
    assert port.rebalance() == ref.rebalance()      # the EMA moved on
    np.testing.assert_array_equal(port.assignment, ref.assignment)
    _assert_state(port, ref)
    for st in (port, ref):
        st.wipe_shard(2)
    _assert_state(port, ref)
    ref_slice = jax.device_get(ref.shard_state("t", 1))
    got = port.shard_state("t", 1)
    np.testing.assert_array_equal(got["keys"].numpy(),
                                  np.asarray(ref_slice["keys"]))
    assert int(got["count"]) == int(ref_slice["count"])


def test_install_shard_and_snapshots_keep_their_bytes():
    """Snapshots cut before ``install_shard``, ``wipe_shard``,
    ``rebalance`` and ``evict`` keep their tensors' bytes and routing:
    every mutation builds new stacked tensors."""
    port, _ = _stores(capacity=256)
    rng = np.random.default_rng(6)
    keys, ts, cols = _batch(rng, 120)
    keys[:60] = 5
    port.put_many("t", keys, ts, cols)
    snap = port.snapshot()
    frozen = {k: v.clone() for k, v in snap.tables["t"].items()
              if k != "cols"}
    frozen_cols = {c: v.clone()
                   for c, v in snap.tables["t"]["cols"].items()}
    assignment = snap.assignment.copy()
    part = port.shard_state("t", 0)
    port.install_shard(1, {"t": part})
    assert torch.equal(port.tables["t"]["keys"][1], part["keys"])
    port.wipe_shard(0)
    assert port.rebalance()
    port.evict("t", 500)
    for k, v in frozen.items():
        assert torch.equal(snap.tables["t"][k], v), k
    for c, v in frozen_cols.items():
        assert torch.equal(snap.tables["t"]["cols"][c], v), c
    np.testing.assert_array_equal(snap.assignment, assignment)
    assert not np.array_equal(port.assignment, assignment)
    np.testing.assert_array_equal(snap.owner_of_keys(keys),
                                  assignment[port.route_slots(keys)])
    snap.refresh()
    np.testing.assert_array_equal(snap.assignment, port.assignment)


def test_rebalance_crash_between_build_and_commit(monkeypatch):
    """A crash after some migrated states are built but before the commit
    leaves routing and every table as they were; a retry succeeds."""
    port, _ = _stores(capacity=256)
    port.create_table("u", {"v": np.float32})
    rng = np.random.default_rng(7)
    keys, ts, cols = _batch(rng, 100)
    keys[:50] = 9
    port.put_many("t", keys, ts, cols)
    port.put_many("u", keys, ts, {"v": cols["v"]})
    before = {t: dict(st) for t, st in port.tables.items()}
    assign = port.assignment.copy()
    real = ShardedOnlineStore._build_state
    calls = {"n": 0}

    def crashing(self, *args, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected crash before commit")
        return real(self, *args, **kw)

    monkeypatch.setattr(ShardedOnlineStore, "_build_state", crashing)
    with pytest.raises(RuntimeError, match="injected crash"):
        port.rebalance()
    monkeypatch.setattr(ShardedOnlineStore, "_build_state", real)
    np.testing.assert_array_equal(port.assignment, assign)
    for t, st in before.items():
        assert port.tables[t]["keys"] is st["keys"]
    port.put_many("t", keys, ts, cols)
    assert port.rebalance()
    assert port.n_rows("t") == 200 and port.n_rows("u") == 100


def test_mesh_is_not_ported():
    """Every entry point takes a mesh (one shard per mesh entry): with a
    ``Mesh`` of two CPU entries each runs sharded (the store and engine
    over 2 shards, ``offline_sharded`` bitwise ``offline()``, the gate
    bitwise), and a mesh without the shard axis raises the reference's
    ``ValueError`` naming it in each."""
    tables = make_action_tables(n_actions=40, n_orders=0, n_users=4,
                                seed=1, with_profile=False)
    sql = """
    SELECT sum(price) OVER w AS s FROM actions
    WINDOW w AS (PARTITION BY userid ORDER BY ts
                 ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW)
    """
    cs = compile_script(sql, tables=tables)
    cpu = torch.device("cpu")
    mesh = Mesh([cpu, cpu], ("shard",))
    assert ShardedOnlineStore(64, mesh=mesh).n_shards == 2
    assert FeatureEngine(sql, tables, mesh=mesh).store.n_shards == 2
    want = cs.offline(tables, device="cpu")
    got = cs.offline_sharded(tables, mesh=mesh)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    rep = verify_consistency(cs, tables, mesh=mesh)
    assert rep.passed and rep.bitwise_equal, str(rep)
    bad = Mesh([cpu, cpu], ("model",))
    for call in (
            lambda: ShardedOnlineStore(64, n_shards=2, mesh=bad),
            lambda: FeatureEngine(sql, tables, mesh=bad),
            lambda: cs.offline_sharded(tables, mesh=bad),
            lambda: verify_consistency(cs, tables, mesh=bad)):
        with pytest.raises(ValueError, match="no axis 'shard'"):
            call()


# ------------------------------------------------------ sharded planes


def _owned(owner, n_shards, n_keys=8):
    m = np.zeros((n_shards, n_keys), bool)
    m[owner, np.arange(n_keys)] = True
    return m


def test_update_many_sharded_equals_reference():
    """In-order and out-of-order batches, then a mask restricted to one
    shard (the recovery replay): every stacked plane and epoch equals
    the reference's broadcast fold."""
    jpa, tpa = _pair()
    owner = np.array([0, 1, 2, 0, 1, 2, 0, 1])
    owned = _owned(owner, 3)
    want = jpa.init_state_stacked(3)
    got = tpa.init_state_stacked(3, "cpu")
    for seed, sort in ((3, True), (4, False)):
        keys, ts, vals = _rows(50, seed, sort=sort)
        want = jpa.update_many_sharded(want, keys, ts, vals, owned)
        got = tpa.update_many_sharded(got, keys, ts, vals, owned)
        _assert_planes(got, want)
    only = np.zeros_like(owned)
    only[1] = owned[1]
    keys, ts, vals = _rows(30, 5, t_lo=3_000, t_hi=6_000)
    _assert_planes(tpa.update_many_sharded(got, keys, ts, vals, only),
                   jpa.update_many_sharded(want, keys, ts, vals, only))
    # a non-owned key's rows stay identity with epoch -1
    assert bool((got["fine_epoch"][1, 0] == -1).all())


def test_migrate_and_restore_planes_equal_reference():
    jpa, tpa = _pair()
    old, new = np.array([0, 1, 2, 0, 1, 2, 0, 1]), \
        np.array([2, 2, 0, 1, 1, 0, 0, 2])
    keys, ts, vals = _rows(60, 9)
    want = jpa.update_many_sharded(jpa.init_state_stacked(3), keys, ts,
                                   vals, _owned(old, 3))
    got = tpa.update_many_sharded(tpa.init_state_stacked(3, "cpu"), keys,
                                  ts, vals, _owned(old, 3))
    frozen = got["fine_epoch"].clone()
    got2 = tpa.migrate_state_sharded(got, old, new)
    want2 = jpa.migrate_state_sharded(want, old, new)
    _assert_planes(got2, want2)
    assert torch.equal(got["fine_epoch"], frozen)      # out of place
    empty_t = tpa.init_state_stacked(3, "cpu")
    empty_j = jpa.init_state_stacked(3)
    got3 = tpa.restore_shard_plane(got2, empty_t, 2)
    _assert_planes(got3, jpa.restore_shard_plane(want2, empty_j, 2))
    _assert_planes(tpa.restore_shard_plane(got3, got2, 2), want2)
    assert torch.equal(got2["fine_epoch"], tpa.migrate_state_sharded(
        got, old, new)["fine_epoch"])


def test_sharded_preagg_rejects_out_of_universe_keys():
    _, tpa = _pair()
    with pytest.raises(ValueError, match="bounded universe"):
        tpa.update_many_sharded(tpa.init_state_stacked(2, "cpu"),
                                np.asarray([9], np.int32),
                                np.asarray([0], np.int32),
                                {"x": np.ones(1, np.float32)},
                                np.ones((2, 8), bool))
    with pytest.raises(ValueError, match="more than one shard"):
        tpa.update_many_sharded(tpa.init_state_stacked(2, "cpu"),
                                np.asarray([3], np.int32),
                                np.asarray([0], np.int32),
                                {"x": np.ones(1, np.float32)},
                                np.ones((2, 8), bool))
