"""The staged fold path, port against reference, and against the port's
own fused path.

``fold_unit`` with ``impl=None`` (per-leaf build/query over a (U, R) block
of units), ``gather_unit`` (the lexsort merge, here one stable sort) and
the staged ``fold_units`` of ``offline()`` are held to the reference's
staged versions on the same numpy-seeded inputs: bitwise, except EW
lanes (``EW_RTOL``: an exp ulp of XLA against torch carried by the fold)
and HLL estimates (``HLL_RTOL``).  Inside the port the staged path equals
the fused path bit for bit, ``ew`` included, and one ``online`` request
equals its row of ``online_batch``.  ``FeatureEngine(fused_fold=False)``
serves ``request`` / ``request_batch`` and ``offline()`` as the
reference's engine does, and ``run_reference_serial`` (the seed
algorithm) equals the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clear_cache as jax_clear_cache
from repro.core import compile_script as jax_compile
from repro.core import multiwindow as jax_mw
from repro.core.lowering import windows as jax_windows
from repro.data.synthetic import make_action_tables as jax_tables
from repro.serve.engine import FeatureEngine as JaxEngine
from repro.storage import timestore as jax_ts
from repro_torch.core import compile_script as torch_compile
from repro_torch.core import multiwindow as torch_mw
from repro_torch.core.lowering import windows as torch_windows
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.serve.engine import FeatureEngine as TorchEngine
from repro_torch.storage import timestore as torch_ts

from conftest import MICRO_SQL
from torch_port_cases import (ACTION_TABLES, EW_ATOL, EW_RTOL, HLL, SQLS,
                              SMOKE_SQL, unit_block)

HLL_RTOL = 1e-6
EW_COLS = {"ew", "ew_price"}
SCRIPTS = {"micro": MICRO_SQL, "smoke": SMOKE_SQL}
N_HIST = 150


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (restored after): the
    suite's parallel workers share the cores, and their thread pools
    fight over them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(name, got, want, hll=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if name in EW_COLS or name.startswith("ew"):
        np.testing.assert_allclose(got, want, rtol=EW_RTOL, atol=EW_ATOL,
                                   err_msg=name)
    elif hll:
        np.testing.assert_allclose(got, want, rtol=HLL_RTOL, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def _groups(compile_fn, windows_mod, sql, **ctx):
    cs = compile_fn(sql, **ctx)
    return {g[0].node.spec.name: g for g in windows_mod.group_windows(
        cs.windows)}


@pytest.mark.parametrize("which", ["family", "edge", "hll"])
@pytest.mark.parametrize("q1", [False, True], ids=["all-rows", "one-query"])
def test_fold_unit_matches_reference_staged(which, q1):
    ctx = HLL if which == "hll" else {}
    sql = SQLS["family" if which == "hll" else which]
    jg = _groups(jax_compile, jax_windows, sql, **ctx)
    tg = _groups(torch_compile, torch_windows, sql, **ctx)
    u, r = 4, 40
    cols = unit_block(u, r, seed=len(which), nan_rows=[(1, 3), (2, 0)])
    rng = np.random.default_rng(1)
    queries = (rng.integers(0, r, (u, 1)).astype(np.int32) if q1 else
               np.broadcast_to(np.arange(r, dtype=np.int32), (u, r)))
    for name, members in tg.items():
        env = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in cols.items()}
        got = torch_windows.fold_unit(members, env, torch.from_numpy(
            np.ascontiguousarray(queries)))
        fused = torch_windows.fold_unit(members, env, torch.from_numpy(
            np.ascontiguousarray(queries)), impl=(True, None))
        for i in range(u):
            want = jax_windows.fold_unit(
                jg[name], {k: jnp.asarray(v[i]) for k, v in cols.items()},
                jnp.asarray(queries[i]))
            for mi, wm in enumerate(want):
                for k, v in wm.items():
                    _close(k, got[mi][k][i].numpy(), v,
                           hll=k.startswith("hll"))
        for mi, gm in enumerate(got):
            for k, v in gm.items():
                np.testing.assert_array_equal(v.numpy(),
                                              fused[mi][k].numpy(),
                                              err_msg=k)


def _stores(sql, n_rows=120):
    """The same rows in the reference's and the port's store."""
    jt = jax_tables(**ACTION_TABLES)
    tt = torch_tables(**ACTION_TABLES)
    jcs, tcs = jax_compile(sql, tables=jt), torch_compile(sql, tables=tt)
    js = jax_ts.OnlineStore(capacity=512)
    ts_ = torch_ts.OnlineStore(capacity=512, device="cpu")
    need = tcs.required_store_columns()
    for t, cols in need.items():
        js.create_table(t, {c: np.float32 for c in cols})
        ts_.create_table(t, {c: np.float32 for c in cols})
    for t in need:
        tab = tt[t]
        n = min(n_rows, len(tab))
        keys = tab.columns["userid"][:n]
        tsa = tab.columns["ts"][:n]
        vals = {c: tab.columns[c][:n].astype(np.float32) for c in need[t]}
        js.put_many(t, keys, tsa, vals)
        ts_.put_many(t, keys, tsa, vals)
    return jt, tt, jcs, tcs, js, ts_


def test_gather_unit_matches_reference():
    jt, tt, jcs, tcs, js, ts_ = _stores(SMOKE_SQL)
    a = tt["actions"]
    rows = [a.row(130 + i) for i in range(5)]
    need = tcs.required_store_columns()["actions"]
    for jm, tm in zip(jax_windows.group_windows(jcs.windows),
                      torch_windows.group_windows(tcs.windows)):
        env, p = torch_windows.gather_unit(
            ts_.tables, tm, torch.tensor([r["userid"] for r in rows],
                                         dtype=torch.int32),
            torch.tensor([r["ts"] for r in rows], dtype=torch.int32),
            {c: torch.tensor([float(r[c]) for r in rows]) for c in need})
        for i, r in enumerate(rows):
            jenv, jp = jax_windows.gather_unit(
                js.tables, jm, jnp.int32(r["userid"]), jnp.int32(r["ts"]),
                {c: jnp.float32(r[c]) for c in need})
            assert int(p[i]) == int(jp)
            for k, v in jenv.items():
                np.testing.assert_array_equal(env[k][i].numpy(),
                                              np.asarray(v), err_msg=k)


@pytest.mark.parametrize("which", ["micro", "smoke", "micro-hll"])
def test_staged_offline_matches_reference_and_fused(which):
    sql = SCRIPTS[which.split("-")[0]]
    ctx = HLL if which.endswith("hll") else {}
    jt, tt = jax_tables(**ACTION_TABLES), torch_tables(**ACTION_TABLES)
    jax_clear_cache()
    want = jax_compile(sql, tables=jt, fused_unit_fold=False,
                       **ctx).offline(jt)
    staged = torch_compile(sql, tables=tt, fused_unit_fold=False,
                           **ctx).offline(tt, device="cpu")
    fused = torch_compile(sql, tables=tt, **ctx).offline(tt, device="cpu")
    assert list(staged) == list(want)
    for k in want:
        _close(k, staged[k], want[k], hll=bool(ctx) and k == "n_cat")
        np.testing.assert_array_equal(staged[k], fused[k], err_msg=k)


@pytest.mark.parametrize("which", sorted(SCRIPTS))
def test_online_equals_online_batch(which):
    _, tt, _, tcs, _, store = _stores(SCRIPTS[which], n_rows=140)
    staged = torch_compile(SCRIPTS[which], tables=tt, fused_unit_fold=False)
    a = tt["actions"]
    rows = [a.row(140 + i) for i in range(5)]
    need = staged.required_store_columns()["actions"]
    keys = [r["userid"] for r in rows]
    tsa = [r["ts"] for r in rows]
    vals = {c: [float(r[c]) for r in rows] for c in need}
    batch = staged.online_batch(store, keys, tsa, vals)
    fused = tcs.online_batch_fast(store, keys, tsa, vals)
    for i, r in enumerate(rows):
        one = staged.online(store, int(r["userid"]), int(r["ts"]),
                            {c: float(r[c]) for c in need})
        for k in batch:
            np.testing.assert_array_equal(one[k], batch[k][i], err_msg=k)
    for k in batch:
        np.testing.assert_array_equal(batch[k], fused[k], err_msg=k)


@pytest.fixture(scope="module", params=sorted(SCRIPTS))
def staged_engines(request):
    sql = SCRIPTS[request.param]
    jt, tt = jax_tables(**ACTION_TABLES), torch_tables(**ACTION_TABLES)
    je = JaxEngine(sql, jt, capacity=1024)
    te = TorchEngine(sql, tt, capacity=1024, device="cpu")
    for eng, t in ((je, jt), (te, tt)):
        eng.bulk_load("orders", t["orders"])
        eng.ingest_many("actions", [t["actions"].row(i)
                                    for i in range(N_HIST)])
    rows = [dict(jt["actions"].row(N_HIST + i)) for i in range(8)]
    # the reference's features, taken once (its batches are bitwise equal
    # to B single requests, so every test slices this one batch): with
    # engines of two scripts in one process, its program cache has handed
    # one script's program to the other on later calls
    return je.request_batch(rows), te, rows


def test_engine_default_is_the_staged_fold(staged_engines):
    _, te, _ = staged_engines
    assert not te.cs.ctx.fused_unit_fold


@pytest.mark.parametrize("b", [1, 3, 8])
def test_staged_request_batch_matches_reference(staged_engines, b):
    want, te, rows = staged_engines
    for w, g in zip(want[:b], te.request_batch(rows[:b])):
        assert set(w) == set(g)
        for k in w:
            _close(k, g[k], w[k])


def test_staged_request_matches_reference(staged_engines):
    """``request`` equals the reference's features and its own row of
    ``request_batch``, bit for bit."""
    want, te, rows = staged_engines
    for row, w in zip(rows[:3], want):
        got = te.request(row)
        for k in w:
            _close(k, got[k], w[k])
        batch = te.request_batch([row])[0]
        for k in got:
            np.testing.assert_array_equal(got[k], batch[k], err_msg=k)


@pytest.mark.parametrize("which", sorted(SCRIPTS))
def test_staged_engine_offline_matches_reference(which):
    jt, tt = jax_tables(**ACTION_TABLES), torch_tables(**ACTION_TABLES)
    je = JaxEngine(SCRIPTS[which], jt, capacity=64)
    te = TorchEngine(SCRIPTS[which], tt, capacity=64, device="cpu")
    jax_clear_cache()       # its offline cache ignores the HLL options
    want, got = je.offline(), te.offline()
    for k in want:
        _close(k, got[k], want[k])


@pytest.mark.parametrize("which", sorted(SCRIPTS))
def test_run_reference_serial_matches_reference(which):
    sql = SCRIPTS[which]
    jt, tt = jax_tables(**ACTION_TABLES), torch_tables(**ACTION_TABLES)
    jax_clear_cache()
    want = jax_mw.run_reference_serial(jax_compile(sql, tables=jt), jt)
    cs = torch_compile(sql, tables=tt)
    got = torch_mw.run_reference_serial(cs, tt, device="cpu")
    assert list(got) == list(want)
    for k in want:
        _close(k, got[k], want[k])
    # against the unit engine: integer-valued columns bitwise
    off = cs.offline(tt, device="cpu")
    for k in ("cnt", "c", "n_cat", "dc", "price_min", "price_max", "mn",
              "mx", "topcat", "cat_h"):
        if k in off:
            np.testing.assert_array_equal(got[k], off[k], err_msg=k)
