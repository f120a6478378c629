"""Offline executor, port against reference, on the same tables.

The §6.2 unit plan is host numpy in both packages and must be the same,
unit for unit.  ``offline()`` runs in the JAX package with
``fused_unit_fold=True`` (the unit fold through its XLA reference, as the
package runs it on the CPU) and in the port on the CPU (the plain
version of the fold).  Features are bitwise equal — integers, counts,
min/max and scan leaves — except the EW lanes, held at ``EW_RTOL`` /
``EW_ATOL`` (an exp/log ulp carried by the fold), and HLL estimates, held
at ``HLL_RTOL`` (the estimate sums ``exp2(-registers)`` in f32, in an
order XLA and torch may choose differently).
"""

import numpy as np
import pytest
import torch

from repro.core import clear_cache as jax_clear_cache
from repro.core import compile_script as jax_compile
from repro.core import skew as jax_skew
from repro.core.lowering import drivers as jax_drivers
from repro.data.synthetic import make_action_tables as jax_tables
from repro_torch.core import compile_script as torch_compile
from repro_torch.core import multiwindow, skew
from repro_torch.core.lowering import drivers as torch_drivers
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import dispatch
from repro_torch.kernels.unit_fold import kernel as K
from repro_torch.kernels.unit_fold import ref as torch_ref
from repro_torch.serve.engine import FeatureEngine

from conftest import MICRO_SQL
from torch_port_cases import ACTION_TABLES, EW_ATOL, EW_RTOL, SMOKE_SQL

HLL_RTOL = 1e-6
SKEWED_TABLES = dict(n_actions=400, n_orders=0, n_users=12,
                     horizon_ms=120_000, zipf_alpha=1.3, seed=1,
                     with_profile=False)
SKEW_SQL = SMOKE_SQL.replace("UNION orders ", "")
# small slices, so the hot keys of the skewed tables are cut with halos
SLICED = dict(offline_slice_rows=32, offline_max_slices=4)

CASES = {
    "micro": (MICRO_SQL, ACTION_TABLES, {}),
    "smoke": (SMOKE_SQL, ACTION_TABLES, {}),
    "skewed-sliced": (SKEW_SQL, SKEWED_TABLES, SLICED),
    "hll": (MICRO_SQL, ACTION_TABLES,
            dict(distinct_hll_p=4, distinct_hll_min_card=8)),
}


def assert_features_equal(want, got, hll=()):
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == "ew":
            np.testing.assert_allclose(b, a, rtol=EW_RTOL, atol=EW_ATOL,
                                       err_msg=k)
        elif k in hll:
            np.testing.assert_allclose(b, a, rtol=HLL_RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.fixture(scope="module", params=sorted(CASES))
def offline_pair(request):
    sql, tkw, ctx = CASES[request.param]
    jt, tt = jax_tables(**tkw), torch_tables(**tkw)
    jcs = jax_compile(sql, tables=jt, fused_unit_fold=True, **ctx)
    tcs = torch_compile(sql, tables=tt, **ctx)
    # the reference's program cache keys on the script, not on the
    # context's HLL options: start each case from an empty cache
    jax_clear_cache()
    return request.param, jcs, jt, tcs, tt, jcs.offline(jt)


def test_offline_matches_reference(offline_pair):
    name, _, _, tcs, tt, want = offline_pair
    got = tcs.offline(tt, device="cpu")
    assert_features_equal(want, got, hll=("n_cat",) if name == "hll" else ())


def test_offline_serial_equals_offline(offline_pair):
    _, _, _, tcs, tt, _ = offline_pair
    fused = tcs.offline(tt, device="cpu")
    serial = tcs.offline_serial(tt, device="cpu")
    for k in fused:
        np.testing.assert_array_equal(serial[k], fused[k], err_msg=k)


def test_branch_outputs_align(offline_pair):
    """Every branch alone gives its features in base-row order: the
    ConcatJoin of the branches is the fused output."""
    _, _, _, tcs, tt, _ = offline_pair
    fused = tcs.offline(tt, device="cpu")
    branches = multiwindow.branch_outputs(tcs, tt, device="cpu")
    assert len(branches) == len(tcs.windows)
    for w, feats in zip(tcs.windows, branches):
        assert list(feats) == w.feature_names
        for k, v in feats.items():
            np.testing.assert_array_equal(v, fused[k], err_msg=k)
    run = multiwindow.run_parallel(tcs, tt, device="cpu")
    for k in fused:
        np.testing.assert_array_equal(run[k], fused[k])


def test_group_lowering_matches_reference(offline_pair):
    """Merged sort (one stable composite sort vs the reference's
    lexsort), units, width classes and block layouts: equal arrays."""
    _, jcs, jt, tcs, tt, _ = offline_pair
    jl, _, jn = jax_drivers.plan_offline(jcs, jt)
    tl, _, tn = torch_drivers.plan_offline(tcs, tt)
    assert jn == tn and len(jl) == len(tl)
    for a, b in zip(jl, tl):
        for f in ("key", "ts", "orig"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert sorted(a.cols) == sorted(b.cols)
        for c in a.cols:
            np.testing.assert_array_equal(b.cols[c], a.cols[c])
        assert a.n_sliced_units == b.n_sliced_units
        assert len(a.blocks) == len(b.blocks)
        for x, y in zip(a.blocks, b.blocks):
            for f in ("unit_ids", "idx", "valid", "emit", "sizes"):
                np.testing.assert_array_equal(getattr(y, f), getattr(x, f))


def test_sliced_case_slices_hot_keys():
    """The skewed case's plan does cut hot keys into halo'd slices (so
    the parity above covers §6.2 slicing)."""
    sql, tkw, ctx = CASES["skewed-sliced"]
    tt = torch_tables(**tkw)
    lws, _, _ = torch_drivers.plan_offline(
        torch_compile(sql, tables=tt, **ctx), tt)
    assert sum(gl.n_sliced_units for gl in lws) > 0
    assert any((b.emit.sum(1) < b.valid.sum(1)).any()
               for gl in lws for b in gl.blocks)


@pytest.mark.parametrize("which", ["action", "skewed"])
@pytest.mark.parametrize("constraints", [
    [(False, 3000)], [(True, 100)], [(False, 60_000), (True, 5)]])
@pytest.mark.parametrize("target_rows,max_slices",
                         [(1024, 8), (16, 4), (8, 1)])
def test_plan_window_units_matches_reference(action_tables, skewed_tables,
                                             which, constraints,
                                             target_rows, max_slices):
    t = (action_tables if which == "action" else skewed_tables)["actions"]
    cols = t.device_columns()
    key = np.asarray(cols["userid"], np.int64)
    ts = np.asarray(cols["ts"], np.int64)
    perm = np.lexsort((np.arange(key.shape[0]), ts, key))
    key_s, ts_s = key[perm], ts[perm].astype(np.int32)
    want = jax_skew.plan_window_units(
        key_s, ts_s, constraints=constraints, target_rows=target_rows,
        max_slices=max_slices)
    got = skew.plan_window_units(
        key_s, ts_s, constraints=constraints, target_rows=target_rows,
        max_slices=max_slices)
    assert [(u.lo, u.emit_lo, u.hi, u.sliced) for u in got] == \
        [(u.lo, u.emit_lo, u.hi, u.sliced) for u in want]
    sizes = [u.n_rows for u in got]
    np.testing.assert_array_equal(skew.assign_units_lpt(sizes, 3),
                                  jax_skew.assign_units_lpt(sizes, 3))


def test_skew_sketch_matches_reference(skewed_tables):
    cols = skewed_tables["actions"].device_columns()
    keys, ts = cols["userid"], cols["ts"]
    a = jax_skew.plan_partitions(keys, ts, 4)
    b = skew.plan_partitions(keys, ts, 4)
    np.testing.assert_array_equal(b.boundaries, a.boundaries)
    np.testing.assert_array_equal(b.hot_keys, a.hot_keys)
    assert b.est_n_keys == a.est_n_keys
    np.testing.assert_array_equal(skew.detect_skew(keys),
                                  jax_skew.detect_skew(keys))


WIDE_SQL = """
SELECT sum(price) OVER w AS s, min(price) OVER w AS mn,
       max(price) OVER w AS mx, count(price) OVER w AS c,
       drawdown(price) OVER wr AS dd, ew_avg(price, 0.5) OVER wr AS ew
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW),
  wr AS (PARTITION BY userid ORDER BY ts
         ROWS BETWEEN 40 PRECEDING AND CURRENT ROW)
"""
WIDE_TABLES = dict(n_actions=5000, n_orders=0, n_users=1,
                   horizon_ms=600_000, seed=5, with_profile=False)


def test_wide_unit_folds_on_the_plain_path():
    """One key of 5,000 rows, unsliced: one unit at rp = 8192, queried at
    every row.  The kernel's shared memory cannot hold its min/max sparse
    table, so the wrapper picks the wide (global-memory) variant; on the
    CPU the same plan folds on the plain path and equals the
    reference."""
    jt, tt = jax_tables(**WIDE_TABLES), torch_tables(**WIDE_TABLES)
    ctx = dict(offline_max_slices=1)
    tcs = torch_compile(WIDE_SQL, tables=tt, **ctx)
    lws, _, _ = torch_drivers.plan_offline(tcs, tt)
    rp = max(b.idx.shape[1] for gl in lws for b in gl.blocks)
    assert rp == 8192
    for gl in lws:
        members = gl.members
        plan = torch_ref.build_plan(
            [m.node.spec for m in members],
            torch_drivers.group_leaf_set(members), "ts",
            member_keys=[tuple(torch_drivers.unique_leaves(m.aggs))
                         for m in members])
        assert K.lane_tiles(plan, rp) is None
        assert K.variant(plan, rp, rp) == "wide"
        hdr, mode, words, n_tasks = K._header(plan, rp, rp)
        assert mode == "wide" and hdr[9] == 16 and words == K.scratch_words(
            plan, K.wide_tiles(plan), rp)
        assert n_tasks == sum(-(-g.width // t) for g, t in
                              zip(plan.groups, K.wide_tiles(plan)))
    want = jax_compile(WIDE_SQL, tables=jt, fused_unit_fold=True,
                       **ctx).offline(jt)
    assert_features_equal(want, tcs.offline(tt, device="cpu"))


def test_lane_tiles_pick_the_shared_variant_when_it_fits():
    """rp = 2048 at Q = rp (the uniform deployment's offline units) and
    4096 fit shared memory with a min/max sparse table; 8192 does not.
    One lane of an ADD scan still fits at 16,384, not at 32,768."""
    tcs = torch_compile(WIDE_SQL)
    members = [w for w in tcs.windows if w.node.spec.name == "w"]
    plan = torch_ref.build_plan(
        [m.node.spec for m in members],
        torch_drivers.group_leaf_set(members), "ts")
    assert K.lane_tiles(plan, 2048) is not None
    assert K.lane_tiles(plan, 4096) is not None
    assert K.lane_tiles(plan, 8192) is None
    assert K.many_smem_bytes("scan", 16384, 1) <= K.SMEM_LIMIT
    assert K.many_smem_bytes("scan", 32768, 1) > K.SMEM_LIMIT


def test_offline_plan_cache_sees_data_mutation():
    t = torch_tables(**ACTION_TABLES)
    cs = torch_compile(SMOKE_SQL, tables=t)
    a = cs.offline(t, device="cpu")
    assert cs.offline(t, device="cpu")["s"].tobytes() == a["s"].tobytes()
    t["actions"].columns["price"][:] += 1.0
    b = cs.offline(t, device="cpu")
    assert not np.array_equal(a["s"], b["s"])
    assert len(cs._offline_plan_cache) == 1


def test_engine_offline_equals_script_offline():
    t = torch_tables(**ACTION_TABLES)
    eng = FeatureEngine(SMOKE_SQL, t, capacity=64, fused_fold=True,
                        device="cpu")
    want = torch_compile(SMOKE_SQL, tables=t).offline(t, device="cpu")
    got = eng.offline()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_offline_runs_the_fold_once_per_block_and_counts_no_launch():
    """On the CPU the fold runs its plain version: no kernel launch is
    counted, and the kernel cannot be forced."""
    t = torch_tables(**ACTION_TABLES)
    dispatch.reset_launch_counts()
    torch_compile(SMOKE_SQL, tables=t).offline(t, device="cpu")
    assert dispatch.launch_counts() == {}
    forced = torch_compile(SMOKE_SQL, tables=t, unit_fold_kernel=True)
    with pytest.raises(dispatch.KernelUnsupportedError):
        forced.offline(t, device="cpu")


def test_offline_on_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t = torch_tables(**ACTION_TABLES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_compile(SMOKE_SQL, tables=t).offline(t)


def test_unported_offline_schedules_raise():
    """``offline_sharded`` is ported (bitwise ``offline()``), with its
    ``mesh`` option (one shard per mesh device) too; a mesh without the
    shard axis raises a ``ValueError`` naming it."""
    t = torch_tables(**ACTION_TABLES)
    cs = torch_compile(SMOKE_SQL, tables=t)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="no axis 'shard'"):
        cs.offline_sharded(t, mesh=Mesh([cpu, cpu], ("model",)))
    want = cs.offline(t, device="cpu")
    for got in (cs.offline_sharded(t, n_shards=2, device="cpu"),
                cs.offline_sharded(t, mesh=Mesh([cpu, cpu], ("shard",)))):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
