"""Replicas, failover, the consistency gate and rebalance of the
key-sharded engine on a device mesh, port against reference: a ``Mesh``
of four CPU entries against the port's stacked ``n_shards=4`` engine
(bitwise) and the reference's ``n_shards=4`` engine (the assignment, the
rows per shard and the planes' epochs; features bitwise, ``ew`` at
``EW_RTOL`` / ``EW_ATOL``).  Placement is checked as in
``test_torch_mesh_store.py``, followers on the mesh entry
``(s + 1 + r) % 4``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import compile_script, verify_consistency
from repro_torch.core.consistency import replay_online
from repro_torch.data.synthetic import make_action_tables as torch_tables

from test_torch_mesh_store import (N, PREAGG_SQL, SKEWED_TABLES,
                                   _assert_feats, _assert_placed, _engines,
                                   _mesh, _parity)
from torch_port_cases import ACTION_TABLES, SMOKE_SQL


@pytest.mark.parametrize("use_preagg", [False, True], ids=["raw", "preagg"])
def test_mesh_consistency_gate_with_failover(use_preagg):
    """The replay through a mid-stream kill + failover on the mesh is
    bitwise the stacked replay's; the gate against ``offline_sharded`` on
    the mesh passes (bitwise raw; pre-agg at the gate's default
    tolerance, its bucket partials re-bracket float sums)."""
    tt = torch_tables(**dict(ACTION_TABLES, n_actions=90, n_orders=60))
    sql = PREAGG_SQL if use_preagg else SMOKE_SQL
    cs = compile_script(sql, tables=tt)
    kw = dict(use_preagg=use_preagg, replication=1,
              kill_shard_at=len(tt["actions"]) // 2)
    got = replay_online(cs, tt, mesh=_mesh(), **kw)
    want = replay_online(cs, tt, n_shards=N, device="cpu", **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rep = verify_consistency(cs, tt, mesh=_mesh(), online_outputs=got,
                             use_preagg=use_preagg)
    assert rep.passed and (use_preagg or rep.bitwise_equal), str(rep)


def test_mesh_kill_heal_bitwise_with_followers_on_other_entries():
    engines, tt, mesh = _engines(PREAGG_SQL, SKEWED_TABLES, 200,
                                 capacity=512, use_preagg=True,
                                 replication=2, ship_every=16,
                                 reference=False)
    port, stacked, _ = engines
    probe = [tt["actions"].row(250 + i) for i in range(8)]
    before = _parity(engines, probe)
    _assert_placed(port, mesh)
    for s in range(N):
        for r in range(2):
            f = port.repl.followers[(s, r)]
            for k in ("keys", "ts", "count"):
                assert torch.equal(f.tables["actions"][k],
                                   port.store.shard_state("actions", s)[k])
    victim = int(port.store.owner_of_keys([probe[0]["userid"]])[0])
    killed = port.kill_shard(victim)
    assert port.store.n_rows_per_shard("actions")[victim] == 0
    assert killed["shard"] == victim
    more = [tt["actions"].row(200 + i) for i in range(30)]
    for e in engines[:2]:
        e.ingest_many("actions", more)
    (rec,) = port.heal()
    assert rec.shard == victim and rec.recovery_s >= 0
    stacked.kill_shard(victim)
    stacked.heal()
    _assert_placed(port, mesh)
    after = _parity(engines, probe)
    assert not all(np.array_equal(a["s"], b["s"])
                   for a, b in zip(after, before))


def test_mesh_rebalance_equals_stacked_and_reference():
    engines, tt, mesh = _engines(PREAGG_SQL, SKEWED_TABLES, 200,
                                 capacity=512, use_preagg=True)
    port, stacked, ref = engines
    rows = [tt["actions"].row(250 + i) for i in range(8)]
    before = _parity(engines, rows)
    assert port.rebalance() and stacked.rebalance() and ref.rebalance()
    np.testing.assert_array_equal(port.store.assignment, ref.store.assignment)
    np.testing.assert_array_equal(port.store.n_rows_per_shard("actions"),
                                  ref.store.n_rows_per_shard("actions"))
    for s in range(N):
        got = port.store.shard_state("actions", s)
        want = stacked.store.shard_state("actions", s)
        assert all(torch.equal(got[k], want[k]) for k in ("keys", "ts"))
    for lvl in ("fine_epoch", "coarse_epoch"):
        got = torch.cat([p[lvl] for p in port.pre_states[0]])
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref.pre_states[0][lvl]))
    _assert_placed(port, mesh)
    _assert_feats(_parity(engines, rows), before, loose=False)


def test_mesh_checkpoint_and_cold_recovery(tmp_path):
    """No follower survives: a mesh store's shard comes back from a
    checkpoint of its tables (one-shard states, saved from and restored
    to their entries) cut at a binlog watermark plus the binlog tail,
    bitwise the stacked store's slice, on its entry."""
    from repro_torch.distributed.fault import CheckpointManager
    from repro_torch.storage.replication import cold_recover_shard

    engines, tt, mesh = _engines(SMOKE_SQL, ACTION_TABLES, 80,
                                 load=("orders", "actions"),
                                 reference=False, fused_fold=True)
    port, stacked, _ = engines
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(port.store._binlog_offset, dict(port.store.tables))
    rows = [tt["actions"].row(80 + i) for i in range(40)]
    for e in engines[:2]:
        e.ingest_many("actions", rows)
    dead = int(port.store.owner_of_keys([rows[0]["userid"]])[0])
    port.store.wipe_shard(dead)
    assert port.store.n_rows_per_shard("actions")[dead] == 0
    assert cold_recover_shard(port.store, ckpt, dead) > 0
    for t in ("actions", "orders"):
        got = port.store.shard_state(t, dead)
        want = stacked.store.shard_state(t, dead)
        for k in ("keys", "ts", "count", "comp"):
            assert torch.equal(got[k], want[k]), (t, k)
    _assert_placed(port, mesh)
    _parity(engines, [tt["actions"].row(130 + i) for i in range(8)])
