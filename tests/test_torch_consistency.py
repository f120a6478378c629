"""The consistency gate in the port, and the replay against the
reference's.

Inside the port, ``verify_consistency(bitwise=True)`` must pass on raw
serving: the offline fold and the request path run one unit fold over
the same rows at the same positions, so the features are
``array_equal``, floats included.  Across packages, ``replay_online``
(every base row served through the single-request ``online`` against a
store filled row by row) must give the reference's features: bitwise,
except the EW lanes at ``EW_RTOL`` / ``EW_ATOL`` (an exp/log ulp carried
by the fold).
"""

import numpy as np
import pytest
import torch

from repro.core import compile_script as jax_compile
from repro.core import replay_online as jax_replay
from repro_torch.core import compile_script, replay_online, \
    verify_consistency
from repro_torch.data.synthetic import make_action_tables
from repro_torch.distributed.sharding import Mesh

from torch_port_cases import ACTION_TABLES, EW_ATOL, EW_RTOL, SMOKE_SQL

ROWS_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       max(price) OVER w AS mx
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS BETWEEN 9 PRECEDING AND CURRENT ROW)
"""

JOIN_SQL = """
SELECT price, profile.age AS age, profile.score * 2 AS dscore,
  sum(price) OVER w AS s
FROM actions
LAST JOIN profile ORDER BY ts ON actions.userid = profile.userid
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 3s PRECEDING AND CURRENT ROW)
"""

ROWS_TABLES = dict(n_actions=150, n_orders=0, n_users=4, seed=3,
                   with_profile=False)


@pytest.mark.parametrize("which", ["micro", "smoke", "rows", "join"])
def test_verify_consistency_bitwise_on_raw_serving(which, micro_sql):
    sql = {"micro": micro_sql, "smoke": SMOKE_SQL, "rows": ROWS_SQL,
           "join": JOIN_SQL}[which]
    tables = make_action_tables(**(ROWS_TABLES if which == "rows"
                                   else ACTION_TABLES))
    cs = compile_script(sql, tables=tables)
    rep = verify_consistency(cs, tables, bitwise=True, device="cpu")
    assert rep.passed and rep.bitwise_equal and rep.bitwise_gate, str(rep)
    assert rep.n_rows == len(tables["actions"])


@pytest.mark.parametrize("which", ["micro", "join"])
def test_replay_online_matches_reference(which, action_tables, micro_sql):
    sql = micro_sql if which == "micro" else JOIN_SQL
    want = jax_replay(jax_compile(sql, tables=action_tables), action_tables)
    t_tables = make_action_tables(**ACTION_TABLES)
    got = replay_online(compile_script(sql, tables=t_tables), t_tables,
                        device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(want[k]), got[k]
        assert a.shape == b.shape, k
        if k == "ew":
            np.testing.assert_allclose(b, a, rtol=EW_RTOL, atol=EW_ATOL)
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=k)


def test_online_outputs_hook_and_mismatch_report():
    tables = make_action_tables(**ACTION_TABLES)
    cs = compile_script(SMOKE_SQL, tables=tables)
    offline = cs.offline(tables, device="cpu")
    rep = verify_consistency(cs, tables, online_outputs=offline,
                             device="cpu")
    assert rep.passed and rep.bitwise_equal
    bad = dict(offline, s=offline["s"] + 1e-3)
    rep = verify_consistency(cs, tables, online_outputs=bad, device="cpu")
    assert not rep.passed and rep.mismatched == ["s"]
    rep = verify_consistency(cs, tables, online_outputs=bad, bitwise=False,
                             device="cpu")
    assert rep.passed and rep.n_exact == rep.n_features - 1
    assert "mismatched" not in str(rep)


def test_single_request_online_equals_batched_path():
    tables = make_action_tables(**ACTION_TABLES)
    from repro_torch.storage.timestore import OnlineStore

    cs = compile_script(SMOKE_SQL, tables=tables)
    store = OnlineStore(capacity=1024, device="cpu")
    for t, cols in cs.required_store_columns().items():
        store.create_table(t, {c: np.float32 for c in cols})
    a, o = tables["actions"], tables["orders"]
    store.put_many("orders", o.columns["userid"], o.columns["ts"],
                   {c: o.columns[c].astype(np.float32)
                    for c in cs.required_store_columns()["orders"]})
    rows = [a.row(i) for i in range(5)]
    need = cs.required_store_columns()["actions"]
    batch = cs.online_batch_fast(
        store, [r["userid"] for r in rows], [r["ts"] for r in rows],
        {c: [float(r[c]) for r in rows] for c in need})
    for i, r in enumerate(rows):
        one = cs.online(store, int(r["userid"]), int(r["ts"]),
                        {c: float(r[c]) for c in need})
        for k in batch:
            np.testing.assert_array_equal(one[k], batch[k][i], err_msg=k)


@pytest.mark.parametrize("option", [
    {"n_shards": 2}, {"mesh": 2},
    {"replication": 1}, {"kill_shard_at": 3}])
def test_unported_options_raise(option):
    """Every deployment option of the gate is ported.  ``n_shards`` and
    ``mesh`` (here a ``Mesh`` of two CPU entries) run the sharded gate
    (bitwise), and ``replication`` / ``kill_shard_at`` without a sharded,
    replicated replay raise the reference's ``ValueError`` naming the
    option."""
    tables = make_action_tables(**ACTION_TABLES)
    cs = compile_script(SMOKE_SQL, tables=tables)
    name = next(iter(option))
    if name == "mesh":
        option = {"mesh": Mesh([torch.device("cpu")] * 2, ("shard",))}
    if name in ("n_shards", "mesh"):
        rep = verify_consistency(cs, tables, device="cpu", **option)
        assert rep.passed and rep.bitwise_equal, str(rep)
        return
    with pytest.raises(ValueError, match=name):
        verify_consistency(cs, tables, device="cpu", **option)
    with pytest.raises(ValueError, match=name):
        replay_online(cs, tables, device="cpu", **option)
