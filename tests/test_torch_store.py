"""Online store, port against reference: the same loads and inserts give
the same sorted state, and the same seeks give the same integers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.storage import timestore as JT
from repro_torch.storage import timestore as TT

CAP = 512
SPECS = {"price": np.float32, "category": np.int32}


def _rows(n, seed, n_keys=6, horizon=300):
    """Rows with many equal (key, ts) peers, so arrival order matters."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n).astype(np.int32)
    ts = rng.integers(0, horizon, n).astype(np.int32)
    cols = {"price": rng.uniform(1, 100, n).astype(np.float32),
            "category": rng.integers(0, 8, n).astype(np.int32)}
    return keys, ts, cols


def _stores():
    js, ts_ = JT.OnlineStore(CAP), TT.OnlineStore(CAP, device="cpu")
    for s in (js, ts_):
        s.create_table("t", SPECS)
    return js, ts_


def _assert_state_equal(jstate, tstate):
    for k in ("keys", "ts"):
        np.testing.assert_array_equal(tstate[k].numpy(),
                                      np.asarray(jstate[k]), err_msg=k)
    assert int(tstate["count"]) == int(jstate["count"])
    for c in jstate["cols"]:
        np.testing.assert_array_equal(tstate["cols"][c].numpy(),
                                      np.asarray(jstate["cols"][c]),
                                      err_msg=c)
    np.testing.assert_array_equal(
        tstate["comp"].numpy(),
        TT.composite(tstate["keys"], tstate["ts"]).numpy())


@pytest.mark.parametrize("n_load,batches", [(200, [37, 1, 64]),
                                            (0, [5, 5, 5]), (300, [])])
def test_bulk_load_and_put_many_match(n_load, batches):
    js, ts_ = _stores()
    if n_load:
        k, t, c = _rows(n_load, seed=1)
        js.bulk_load("t", k, t, c)
        ts_.bulk_load("t", k, t, c)
    for i, n in enumerate(batches):
        k, t, c = _rows(n, seed=10 + i)
        assert js.put_many("t", k, t, c) == ts_.put_many("t", k, t, c)
    _assert_state_equal(js.tables["t"], ts_.tables["t"])
    assert ts_.binlog == js.binlog
    assert ts_.n_rows("t") == js.n_rows("t")


def test_insert_many_matches_lexsort_order():
    k0, t0, c0 = _rows(100, seed=2)
    jstate = JT.make_state(CAP, SPECS)
    jstate = JT.insert_many(jstate, jnp.asarray(k0), jnp.asarray(t0),
                            {c: jnp.asarray(v) for c, v in c0.items()}, 100)
    tstate = TT.make_state(CAP, SPECS, "cpu")
    tstate = TT.insert_many(tstate, torch.from_numpy(k0),
                            torch.from_numpy(t0),
                            {c: torch.from_numpy(v) for c, v in c0.items()},
                            100)
    # a second batch lands after its existing (key, ts) peers
    k1, t1, c1 = _rows(64, seed=3)
    jstate = JT.insert_many(jstate, jnp.asarray(k1), jnp.asarray(t1),
                            {c: jnp.asarray(v) for c, v in c1.items()}, 64)
    tstate = TT.insert_many(tstate, torch.from_numpy(k1),
                            torch.from_numpy(t1),
                            {c: torch.from_numpy(v) for c, v in c1.items()},
                            64)
    _assert_state_equal(jstate, tstate)


def test_range_bounds_and_gather_key_unit_match():
    js, ts_ = _stores()
    k, t, c = _rows(400, seed=4)
    js.bulk_load("t", k, t, c)
    ts_.bulk_load("t", k, t, c)
    rng = np.random.default_rng(5)
    qk = rng.integers(-1, 8, 40).astype(np.int32)     # incl. absent keys
    q0 = rng.integers(-10, 310, 40).astype(np.int32)
    q1 = (q0 + rng.integers(-5, 120, 40)).astype(np.int32)
    jst, tst = js.tables["t"], ts_.tables["t"]
    lo_t, hi_t = TT.range_bounds(tst, torch.from_numpy(qk),
                                 torch.from_numpy(q0), torch.from_numpy(q1))
    cols_t, tsb_t, valid_t = TT.gather_key_unit(
        tst, torch.from_numpy(qk), torch.from_numpy(q1), 16,
        ["price", "category"])
    assert lo_t.dtype == torch.int32 and tsb_t.dtype == torch.int32
    lo_j, hi_j = jax.jit(jax.vmap(
        lambda a, b, e: JT.range_bounds(jst, a, b, e)))(qk, q0, q1)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    cols_j, tsb_j, valid_j = jax.jit(jax.vmap(
        lambda a, e: JT.gather_key_unit(jst, a, e, 16,
                                        ["price", "category"])))(qk, q1)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(tsb_t.numpy(), np.asarray(tsb_j))
    for name in cols_j:
        np.testing.assert_array_equal(cols_t[name].numpy(),
                                      np.asarray(cols_j[name]))


def test_load_state_carries_a_reference_state():
    js, ts_ = _stores()
    k, t, c = _rows(150, seed=6)
    js.bulk_load("t", k, t, c)
    js.put_many("t", *_rows(20, seed=7))
    ts_.load_state("t", jax.tree.map(np.asarray, js.tables["t"]))
    _assert_state_equal(js.tables["t"], ts_.tables["t"])
    snap = ts_.snapshot()
    ts_.put_many("t", *_rows(3, seed=8))
    assert snap.n_rows("t") == 170 and ts_.n_rows("t") == 173


def test_capacity_overflow_raises():
    _, ts_ = _stores()
    with pytest.raises(ValueError):
        ts_.bulk_load("t", *_rows(CAP + 1, seed=9))
