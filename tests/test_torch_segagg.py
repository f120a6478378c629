"""Segmented sums and the bucket build, port against reference, on the
same numpy inputs.

The port is held to the reference's ``ref.py`` (``segment_sum`` after
``where(ok)``), as its own kernel test holds the Pallas kernel
(``tests/test_kernels.py::test_segagg_shapes``), at the reference's bar,
rtol 1e-4 / atol 1e-4.  The JAX Pallas kernel in interpret mode is
compared where it agrees with ``ref.py`` — everywhere except NaN, which
its one-hot product spreads over a whole segment tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segagg import ops as jax_ops
from repro.kernels.segagg.ref import segagg_ref as jax_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.segagg import bucket_build, segagg

RTOL = ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,f,s", [(64, 4, 8), (1000, 16, 50),
                                   (257, 1, 3), (512, 33, 128)])
def test_segagg_shapes(n, f, s):
    rng = np.random.default_rng(n)
    vals = rng.standard_normal((n, f)).astype(np.float32)
    segs = np.sort(rng.integers(0, s, n)).astype(np.int32)
    want = np.asarray(jax_ref(jnp.asarray(vals), jnp.asarray(segs), s))
    pal = np.asarray(jax_ops.segagg(jnp.asarray(vals), jnp.asarray(segs), s,
                                    use_pallas=True))
    got = segagg(_t(vals), _t(segs), s).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)


def test_segagg_unsorted_out_of_range_and_negative_ids():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((100, 3)).astype(np.float32)
    segs = rng.integers(-2, 12, 100).astype(np.int32)
    segs[:3] = [-2**31, 2**31 - 1, 10]
    want = np.asarray(jax_ref(jnp.asarray(vals), jnp.asarray(segs), 10))
    got = segagg(_t(vals), _t(segs), 10).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ok = (segs >= 0) & (segs < 10)
    brute = np.stack([vals[ok & (segs == k)].sum(0) for k in range(10)])
    np.testing.assert_allclose(got, brute, rtol=RTOL, atol=ATOL)


def test_nan_stays_in_its_segment():
    """A NaN value reaches only its own segment; one in a dropped
    (out-of-range) row reaches none."""
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((60, 2)).astype(np.float32)
    segs = (np.arange(60) % 6).astype(np.int32)
    vals[7, 0] = np.nan                # segment 1, lane 0
    segs[8], vals[8, 1] = 40, np.nan   # dropped
    want = np.asarray(jax_ref(jnp.asarray(vals), jnp.asarray(segs), 6))
    got = segagg(_t(vals), _t(segs), 6).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() == 1 and np.isnan(got[1, 0])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bucket_build_counts():
    ts = np.asarray([0, 10, 20, 20, 35], np.int32)
    vals = np.ones((5, 1), np.float32) * 2.0
    out = bucket_build(_t(vals), _t(ts), bucket_ms=10, n_buckets=4).numpy()
    np.testing.assert_allclose(out[:, 1], [1, 1, 2, 1])
    np.testing.assert_allclose(out[:, 0], [2, 2, 4, 2])


@pytest.mark.parametrize("bucket_ms,n_buckets", [(1000, 60), (60, 900),
                                                 (7_000, 4)])
def test_bucket_build_matches_reference(bucket_ms, n_buckets):
    rng = np.random.default_rng(bucket_ms)
    n = 700
    ts = np.sort(rng.integers(-500, 60_000, n)).astype(np.int32)
    vals = rng.uniform(1, 100, (n, 2)).astype(np.float32)
    vals[::97, 0] = np.nan
    want = np.asarray(jax_ops.bucket_build(
        jnp.asarray(vals), jnp.asarray(ts), bucket_ms, n_buckets,
        use_pallas=False))
    got = bucket_build(_t(vals), _t(ts), bucket_ms, n_buckets).numpy()
    assert got.shape == (n_buckets, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_kernel_cannot_be_forced_on_cpu_tensors():
    vals, segs = torch.ones((8, 2)), torch.zeros(8, dtype=torch.int32)
    with pytest.raises(dispatch.KernelUnsupportedError):
        segagg(vals, segs, 2, use_kernel=True)
    before = dict(dispatch.launch_counts())
    segagg(vals, segs, 2)
    assert dispatch.launch_counts() == before
