"""Key-sharded offline execution of the port (``offline_sharded``) —
counterparts of the ``n_shards`` cases of the reference's
``tests/test_offline_sharded.py``.  The claim: the port's
``offline_sharded`` is bitwise equal to its ``offline()`` for every shard
count, on uniform and zipf-skewed data with hot-key time slicing, for
pre-aggregated and UNION scripts, with the staged and the fused fold;
and it equals the reference's ``offline_sharded`` (bitwise, EW and
drawdown at ``EW_RTOL``).  The sharded consistency gate runs both
executors sharded."""

import numpy as np
import pytest

from repro.core import compile_script as jax_compile
from repro.data.synthetic import make_action_tables as jax_tables
from repro_torch.core import compile_script, verify_consistency
from repro_torch.core.lowering.drivers import plan_offline
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.serve.engine import FeatureEngine

from torch_port_cases import EW_ATOL, EW_RTOL

MULTI_SQL = """
SELECT
  sum(price) OVER w1 AS s1, avg(price) OVER w1 AS a1,
  max(price) OVER w2 AS m2, count(price) OVER w2 AS c2,
  drawdown(price) OVER w3 AS d3, ew_avg(price, 0.5) OVER w3 AS e3,
  min(price) OVER w1 AS mn1
FROM actions
WINDOW w1 AS (PARTITION BY userid ORDER BY ts
              ROWS_RANGE BETWEEN 10s PRECEDING AND CURRENT ROW),
      w2 AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 40s PRECEDING AND CURRENT ROW),
      w3 AS (PARTITION BY userid ORDER BY ts
             ROWS BETWEEN 50 PRECEDING AND CURRENT ROW)
"""
PREAGG_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       max(price) OVER w AS mx
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 3000s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "w:100s")
"""
GATE_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       max(price) OVER w AS mx
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 10s PRECEDING AND CURRENT ROW)
"""
UNIFORM = dict(n_actions=400, n_orders=0, n_users=8, horizon_ms=120_000,
               seed=7, with_profile=False)
ZIPF = dict(n_actions=600, n_orders=0, n_users=16, horizon_ms=120_000,
            zipf_alpha=1.4, seed=8, with_profile=False)
LOOSE = ("d3", "e3")


def _bitwise(a, b, msg=""):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{k} {msg}")


def _near_reference(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in LOOSE:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=EW_RTOL, atol=EW_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


@pytest.fixture(scope="module")
def uniform_tables():
    return torch_tables(**UNIFORM)


@pytest.fixture(scope="module")
def zipf_tables():
    return torch_tables(**ZIPF)


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_sharded_bitexact_uniform(uniform_tables, n_shards, fused):
    cs = compile_script(MULTI_SQL, tables=uniform_tables,
                        fused_unit_fold=fused)
    _bitwise(cs.offline(uniform_tables, device="cpu"),
             cs.offline_sharded(uniform_tables, n_shards=n_shards,
                                device="cpu"), f"S={n_shards}")


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_bitexact_skewed_with_slicing(zipf_tables, n_shards):
    """Zipf keys with a slice threshold low enough that hot keys are cut
    into halo-expanded time slices (the full §6.2 path); at 8 shards
    also equal to the reference's ``offline_sharded``."""
    cs = compile_script(MULTI_SQL, tables=zipf_tables,
                        offline_slice_rows=32, offline_max_slices=8)
    lws, _, _ = plan_offline(cs, zipf_tables)
    assert any(lw.n_sliced_units > 0 for lw in lws)
    got = cs.offline_sharded(zipf_tables, n_shards=n_shards, device="cpu")
    _bitwise(cs.offline(zipf_tables, device="cpu"), got,
             f"S={n_shards} sliced")
    if n_shards != 8:
        return
    jt = jax_tables(**ZIPF)
    jcs = jax_compile(MULTI_SQL, tables=jt, offline_slice_rows=32,
                      offline_max_slices=8)
    _near_reference(got, jcs.offline_sharded(jt, n_shards=n_shards))


def test_sharded_bitexact_preagg_script():
    tables = torch_tables(n_actions=300, n_orders=0, n_users=4,
                          horizon_ms=12_000_000, seed=4, with_profile=False)
    cs = compile_script(PREAGG_SQL, tables=tables)
    assert cs.windows[0].preagg is not None
    _bitwise(cs.offline(tables, device="cpu"),
             cs.offline_sharded(tables, n_shards=4, device="cpu"), "preagg")


def test_union_window_sharded():
    kw = dict(n_actions=250, n_orders=150, n_users=6, seed=9,
              with_profile=False)
    tables = torch_tables(**kw)
    sql = """
    SELECT sum(price) OVER w AS s, count(price) OVER w AS c
    FROM actions
    WINDOW w AS (UNION orders PARTITION BY userid ORDER BY ts
                 ROWS_RANGE BETWEEN 30s PRECEDING AND CURRENT ROW
                 MAXSIZE 7)
    """
    cs = compile_script(sql, tables=tables, offline_slice_rows=32)
    got = cs.offline_sharded(tables, n_shards=5, device="cpu")
    _bitwise(cs.offline(tables, device="cpu"), got, "union")
    jt = jax_tables(**kw)
    _near_reference(got, jax_compile(sql, tables=jt, offline_slice_rows=32)
                    .offline_sharded(jt, n_shards=5))


def test_sharded_offline_blocks_keep_the_launch_count(zipf_tables):
    """Each unit class folds as ONE (S·U_pad, R) block: the sharded plan
    has as many blocks as the unsharded one, every unit emitted once."""
    from repro_torch.core.lowering.drivers import _stack_window

    cs = compile_script(MULTI_SQL, tables=zipf_tables,
                        offline_slice_rows=32)
    for gl in plan_offline(cs, zipf_tables)[0]:
        stacked = _stack_window(gl, 8)
        assert len(stacked) == len(gl.blocks)
        for blk, b in zip(stacked, gl.blocks):
            assert blk["idx"].shape[1] == b.idx.shape[1]
            assert blk["idx"].shape[0] % 8 == 0
            assert blk["emit"].sum() == b.emit[:b.unit_ids.size].sum()


def test_sharded_consistency_gate_raw():
    """Sharded offline against the sharded online replay."""
    tables = torch_tables(n_actions=150, n_orders=0, n_users=6, seed=11,
                          with_profile=False)
    cs = compile_script(GATE_SQL, tables=tables)
    rep = verify_consistency(cs, tables, n_shards=4, device="cpu")
    assert rep.passed and rep.bitwise_equal, str(rep)


def test_sharded_consistency_gate_preagg():
    tables = torch_tables(n_actions=120, n_orders=0, n_users=4,
                          horizon_ms=12_000_000, seed=12, with_profile=False)
    cs = compile_script(PREAGG_SQL, tables=tables)
    rep = verify_consistency(cs, tables, use_preagg=True, n_shards=3,
                             device="cpu")
    assert rep.passed, str(rep)


def test_engine_offline_uses_sharded_schedule(uniform_tables):
    """A sharded engine materializes through ``offline_sharded``, equal
    to the unsharded engine bitwise."""
    sql = GATE_SQL.replace("max(price) OVER w AS mx",
                           "min(price) OVER w AS m")
    plain = FeatureEngine(sql, uniform_tables, capacity=512, device="cpu")
    sharded = FeatureEngine(sql, uniform_tables, capacity=512, n_shards=4,
                            device="cpu")
    calls = []
    real = sharded.cs.offline_sharded
    sharded.cs.offline_sharded = lambda *a, **k: calls.append(k) or real(
        *a, **k)
    _bitwise(plain.offline(), sharded.offline(), "engine")
    assert calls and calls[0]["n_shards"] == 4


def test_offline_sharded_scalar_only_script(uniform_tables):
    sql = "SELECT price * 2 AS p, quantity AS q FROM actions"
    cs = compile_script(sql, tables=uniform_tables)
    _bitwise(cs.offline(uniform_tables, device="cpu"),
             cs.offline_sharded(uniform_tables, n_shards=4, device="cpu"),
             "scalar-only")
