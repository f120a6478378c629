"""Public names the port adds to modules it had already ported, each held
bitwise to the JAX package on the CPU:

* ``core.skew``: ``assign_part_ids``, ``expand_partitions`` and
  ``skewed_window_fold`` (the paper's §6.2 pipeline around a fold, host
  numpy: equal arrays);
* ``kernels.signature_batch`` (the LibSVM-style batch around the feature
  hash: equal indices, ones and dense block);
* ``storage.timestore.insert`` / ``insert_pos`` (the single-row sorted
  insert: every column, ``count`` and the derived ``comp`` after each of
  a stream of inserts, into a store that fills and overflows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skew as JSK
from repro.kernels import signature_batch as jax_signature_batch
from repro.storage import timestore as JT
from repro_torch import kernels as TK
from repro_torch.core import skew as TSK
from repro_torch.storage import timestore as TT


def _skewed_rows(seed, n=400, n_keys=6):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_keys + 1) ** 1.2
    keys = rng.choice(n_keys, n, p=p / p.sum()).astype(np.int64)
    ts = np.sort(rng.choice(np.arange(1, 60_000), n, replace=False))
    return keys, ts, rng.uniform(0, 5, n)


def _window_sum_fold(window_ms):
    """Per-row sum over the same key's rows within [ts - window, ts]."""
    def fold(keys, ts, vals):
        out = np.zeros(len(keys))
        for i in range(len(keys)):
            m = (keys == keys[i]) & (ts <= ts[i]) & (ts >= ts[i] - window_ms)
            out[i] = vals[m].sum()
        return out
    return fold


@pytest.mark.parametrize("quantile", [1, 3, 4, 7])
def test_part_ids_and_expansion_equal_the_reference(quantile):
    keys, ts, _ = _skewed_rows(quantile)
    plan = TSK.plan_partitions(keys, ts, quantile)
    jplan = JSK.plan_partitions(keys, ts, quantile)
    np.testing.assert_array_equal(plan.boundaries, jplan.boundaries)
    pid = TSK.assign_part_ids(ts, plan)
    want = JSK.assign_part_ids(ts, jplan)
    assert pid.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(pid, want)
    for window_ms in (0, 700, 5_000):
        got = TSK.expand_partitions(keys, ts, pid, window_ms, plan)
        exp = JSK.expand_partitions(keys, ts, want, window_ms, jplan)
        for g, w in zip(got, exp):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("window_ms", [500, 4_000])
def test_skewed_window_fold_equals_the_reference(window_ms):
    """Bitwise the reference's pipeline, and equal to the unpartitioned
    fold (the reference's own test holds that at rtol 1e-9)."""
    keys, ts, vals = _skewed_rows(11)
    fold = _window_sum_fold(window_ms)
    got = TSK.skewed_window_fold(keys, ts, vals, window_ms, 4, fold)
    want = JSK.skewed_window_fold(keys, ts, vals, window_ms, 4, fold)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, fold(keys, ts, vals), rtol=1e-9)


def test_skew_names_are_exported():
    for name in ("assign_part_ids", "expand_partitions",
                 "skewed_window_fold"):
        assert name in TSK.__all__ and callable(getattr(JSK, name))
    assert "signature_batch" in TK.__all__
    assert "insert" in TT.__all__ and "insert_pos" in TT.__all__


@pytest.mark.parametrize("dim", [1 << 20, 1000, 1])
def test_signature_batch_equals_the_reference(dim):
    rng = np.random.default_rng(dim)
    codes = rng.integers(-2**31, 2**31 - 1, (33, 5)).astype(np.int32)
    dense = rng.standard_normal((33, 3))          # float64: cast to f32
    want = jax_signature_batch(jnp.asarray(codes), jnp.asarray(dense), dim,
                               use_pallas=False)
    got = TK.signature_batch(torch.from_numpy(codes),
                             torch.from_numpy(dense), dim)
    for g, w, dtype in zip(got, want, (torch.int32, torch.float32,
                                       torch.float32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _store_pair(cap):
    specs = {"price": np.float32, "qty": np.int32}
    return (JT.make_state(cap, {"price": jnp.float32, "qty": jnp.int32}),
            TT.make_state(cap, specs, "cpu"))


def _same_state(got, want, what):
    for name in ("keys", "ts", "count"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=what)
    for name, col in got["cols"].items():
        np.testing.assert_array_equal(col.numpy(),
                                      np.asarray(want["cols"][name]),
                                      err_msg=f"{what} {name}")
    assert torch.equal(got["comp"], TT.composite(got["keys"], got["ts"]))


@pytest.mark.parametrize("cap", [8, 64])
def test_insert_equals_the_reference(cap):
    """A stream of 40 inserts with repeated (key, ts) pairs (a new row
    lands after its peers), a missing column (0), a float into the int
    column (truncated) and, at capacity 8, a full store (the last row
    falls off, ``count`` keeps counting, as in the reference)."""
    jstate, tstate = _store_pair(cap)
    rng = np.random.default_rng(cap)
    for i in range(40):
        key, ts = int(rng.integers(0, 4)), int(rng.integers(-3, 6))
        values = {"price": float(rng.standard_normal()),
                  "qty": float(rng.uniform(-9, 9))}
        if i % 7 == 3:
            values = {"price": float(i)}
        assert int(TT.insert_pos(tstate, key, ts)) == int(
            JT.insert_pos(jstate, key, ts))
        jstate = JT.insert(jstate, key, ts, values)
        tstate = TT.insert(tstate, key, ts, values)
        _same_state(tstate, jstate, f"insert {i}")
    assert int(tstate["count"]) == 40


def test_insert_leaves_its_input_state_alone():
    """Every mutation of the port returns new tensors (a snapshot may
    hold the old ones)."""
    _, state = _store_pair(16)
    state = TT.insert(state, 1, 5, {"price": 2.0, "qty": 3})
    before = {k: v.clone() for k, v in state.items() if k != "cols"}
    TT.insert(state, 0, 1, {"price": 1.0})
    for k, v in before.items():
        assert torch.equal(state[k], v)
