"""Self-adjusted window union (§5.2), port against reference: the
``LoadBalancer`` EMA and greedy LPT (the routing a sharded store's
``rebalance`` commits) and the ``SlidingAggregator`` Subtract-and-Evict
fold, in both packages on the same numpy-seeded inputs.  The balancer is
host float64 in both, so assignments, split keys and imbalance must be
equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.functions import AddLeaf as JaxAdd
from repro.core.functions import EWLeaf as JaxEW
from repro.core.union import LoadBalancer as JaxBalancer
from repro.core.union import SlidingAggregator as JaxSliding
from repro.core.union import static_hash_assign as jax_static
from repro.data.synthetic import zipf_keys
from repro_torch.core.functions import AddLeaf, EWLeaf, MinLeaf
from repro_torch.core.union import (LoadBalancer, SlidingAggregator,
                                    static_hash_assign)


@pytest.mark.parametrize("n_keys,n_workers", [(64, 8), (1024, 8), (7, 3)])
def test_static_hash_assign_equals_reference(n_keys, n_workers):
    np.testing.assert_array_equal(static_hash_assign(n_keys, n_workers),
                                  jax_static(n_keys, n_workers))


def test_dynamic_balancing_beats_static_hash_under_skew():
    rng = np.random.default_rng(0)
    n_keys, n_workers = 64, 8
    counts = np.bincount(zipf_keys(100_000, n_keys, 1.4, rng),
                         minlength=n_keys).astype(np.float64)
    lbs = [LoadBalancer(n_keys, n_workers), JaxBalancer(n_keys, n_workers)]
    static = [lb.imbalance(counts, static_hash_assign(n_keys, n_workers))
              for lb in lbs]
    for lb in lbs:
        lb.observe(counts)
        lb.rebalance()
    dynamic = [lb.imbalance(counts) for lb in lbs]
    assert dynamic[0] < static[0] and dynamic[0] < 1.5
    assert static[0] == static[1] and dynamic[0] == dynamic[1]
    np.testing.assert_array_equal(lbs[0].assignment, lbs[1].assignment)
    assert lbs[0].split_keys == lbs[1].split_keys


def test_hot_key_splitting():
    lbs = [cls(n_keys=4, n_workers=4, split_threshold=1.2)
           for cls in (LoadBalancer, JaxBalancer)]
    for lb in lbs:
        lb.observe(np.array([1000.0, 10.0, 10.0, 10.0]))
        lb.rebalance()
    assert 0 in lbs[0].split_keys and lbs[0].split_keys[0] > 1
    assert lbs[0].split_keys == lbs[1].split_keys
    np.testing.assert_array_equal(lbs[0].assignment, lbs[1].assignment)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_balancer_ema_and_lpt_equal_reference(seed):
    """The sharded store's balancer (1,024 route slots, splitting off):
    several observe / rebalance rounds of skewed slot loads, with ties
    (equal loads, zero-load slots) — the float64 EMA and the LPT's
    tie-breaking give the reference's assignment array for array."""
    rng = np.random.default_rng(seed)
    lbs = [cls(1024, 8, split_threshold=float("inf"))
           for cls in (LoadBalancer, JaxBalancer)]
    for _ in range(4):
        counts = np.bincount(zipf_keys(5_000, 1024, 1.1, rng),
                             minlength=1024).astype(np.float64)
        counts[rng.integers(0, 1024, 50)] = 7.0        # equal-load ties
        got = [lb.observe(counts) or lb.rebalance() for lb in lbs]
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(lbs[0].load, lbs[1].load)
        assert lbs[0].imbalance(counts) == lbs[1].imbalance(counts)


def test_sliding_aggregator_matches_refold_and_is_o1():
    win = 1000
    aggs = [SlidingAggregator(AddLeaf("sum:x", lambda env: env["x"]), win),
            JaxSliding(JaxAdd("sum:x", lambda env: jnp.asarray(env["x"])),
                       win)]
    rng = np.random.default_rng(1)
    ts = np.sort(rng.integers(0, 20_000, 400))
    vals = rng.uniform(0, 10, 400)
    history = []
    for t, v in zip(ts, vals):
        got = [a.push(1, int(t), np.float32(v)) for a in aggs]
        history.append((int(t), float(v)))
        expect = sum(x for tt, x in history if tt >= t - win)
        np.testing.assert_allclose(float(got[0]), expect, rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(got[0]),
                                      np.asarray(got[1]))
    # O(1) amortized: ~3 combines per push (add + evict + diff)
    assert aggs[0].combines == aggs[1].combines < 4 * len(ts)
    np.testing.assert_array_equal(aggs[0].window_fold(1),
                                  np.asarray(aggs[1].window_fold(1)))


def test_sliding_aggregator_ew_equals_reference():
    """The EW leaf streams through the numpy algebra in both packages;
    its window fold is read back through the leaf's invert_prefix (torch
    in the port, XLA in the reference: within the EW bar)."""
    aggs = [SlidingAggregator(EWLeaf("ew:x", lambda env: env["x"],
                                     decay=0.5), 500),
            JaxSliding(JaxEW("ew:x", lambda env: jnp.asarray(env["x"]),
                             decay=0.5), 500)]
    rng = np.random.default_rng(2)
    for t in np.sort(rng.integers(0, 5_000, 120)):
        lifted = np.asarray([rng.uniform(0, 3), 1.0, 1.0], np.float32)
        got = [a.push(int(t) % 3, int(t), lifted) for a in aggs]
        np.testing.assert_array_equal(got[0], got[1])
    for k in range(3):
        np.testing.assert_allclose(aggs[0].window_fold(k),
                                   np.asarray(aggs[1].window_fold(k)),
                                   rtol=1e-5, atol=1e-6)


def test_sliding_aggregator_rejects_non_invertible_leaf():
    with pytest.raises(ValueError, match="invertible"):
        SlidingAggregator(MinLeaf("min:x", lambda env: env["x"]), 100)
    assert isinstance(AddLeaf("s", lambda env: env["x"]).identity(),
                      torch.Tensor)
