"""Batched request-window fold, port against reference, on the same
numpy inputs.

The JAX side runs as its own test runs it on the CPU
(``tests/test_online_batch.py::test_batch_windowfold_kernel_matches_ref``):
the Pallas kernel in interpret mode and the jnp reference.  The port runs
its plain version on CPU tensors.  Tolerance rtol 1e-5 / atol 1e-5, the
reference's own bar: the port sums the store axis in chunks, the
reference in one product, so the additions are ordered differently.  NaN
positions must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.batch_windowfold import batch_windowfold as jax_bwf
from repro.kernels.batch_windowfold import store_windowfold as jax_swf
from repro.kernels.batch_windowfold.ref import batch_windowfold_ref
from repro.storage.timestore import OnlineStore as JaxStore
from repro_torch.kernels import dispatch
from repro_torch.kernels.batch_windowfold import (batch_windowfold,
                                                  store_windowfold)
from repro_torch.kernels.batch_windowfold import ref as torch_ref
from repro_torch.storage.timestore import OnlineStore

RTOL = ATOL = 1e-5


def _inputs(c, f, b, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 16, size=c)).astype(np.int32)
    ts = rng.integers(0, 10_000, size=c).astype(np.int32)
    vals = rng.normal(size=(c, f)).astype(np.float32)
    qkey = rng.integers(0, 16, size=b).astype(np.int32)
    qt1 = rng.integers(0, 10_000, size=b).astype(np.int32)
    qt0 = qt1 - rng.integers(0, 3_000, size=b).astype(np.int32)
    return keys, ts, vals, qkey, qt0, qt1


def _both(args):
    want_ref = np.asarray(batch_windowfold_ref(*map(jnp.asarray, args)))
    want_pal = np.asarray(jax_bwf(*map(jnp.asarray, args), use_pallas=True,
                                  interpret=True))
    got = batch_windowfold(*(torch.from_numpy(a.copy()) for a in args))
    return want_ref, want_pal, got.numpy()


@pytest.mark.parametrize("c,f,b", [(64, 1, 3), (500, 9, 37),
                                   (130, 17, 130)])
def test_batch_windowfold_matches_reference(c, f, b):
    args = _inputs(c, f, b, seed=2)
    want_ref, want_pal, got = _both(args)
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_pal, rtol=RTOL, atol=ATOL)
    keys, ts, vals, qkey, qt0, qt1 = args
    brute = np.zeros((b, f), np.float32)
    for i in range(b):
        m = (keys == qkey[i]) & (ts >= qt0[i]) & (ts <= qt1[i])
        brute[i] = vals[m].sum(axis=0)
    np.testing.assert_allclose(got, brute, rtol=1e-4, atol=1e-4)


def test_plain_version_chunks_the_store_axis(monkeypatch):
    """Chunking the store axis (so the (B, C) mask is never whole)
    changes only the order of the additions."""
    args = _inputs(500, 3, 37, seed=4)
    t = [torch.from_numpy(a.copy()) for a in args]
    whole = torch_ref.batch_windowfold_ref(*t)
    monkeypatch.setattr(torch_ref, "MASK_ELEMS", 37 * 64)
    chunked = torch_ref.batch_windowfold_ref(*t)
    torch.testing.assert_close(chunked, whole, rtol=RTOL, atol=ATOL)


def test_nan_in_a_row_that_matches_no_request():
    """The reference's product is dense: a NaN value in a row no request
    matches still turns its whole lane NaN (0 * NaN = NaN).  The port
    keeps that quirk, lane for lane."""
    keys, ts, vals, qkey, qt0, qt1 = _inputs(200, 3, 9, seed=5)
    keys[-1] = 99                      # matches no request key
    vals[-1, 1] = np.nan
    args = (keys, ts, vals, qkey, qt0, qt1)
    want_ref, want_pal, got = _both(args)
    for want in (want_ref, want_pal):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isnan(got[:, 1]).all() and not np.isnan(got[:, [0, 2]]).any()


def test_store_windowfold_on_the_stores():
    """A port store and a reference store loaded with the same rows give
    the same folds; rows past the live count are read as 0 even where
    their lifted values are NaN."""
    rng = np.random.default_rng(6)
    n, cap = 300, 512
    keys = rng.integers(0, 8, n).astype(np.int32)
    ts = rng.integers(0, 50_000, n).astype(np.int32)
    price = rng.uniform(1, 100, n).astype(np.float32)
    js, ps = JaxStore(capacity=cap), OnlineStore(capacity=cap, device="cpu")
    for st in (js, ps):
        st.create_table("actions", {"price": np.float32})
        st.bulk_load("actions", keys, ts, {"price": price})
    jstate, tstate = js.tables["actions"], ps.tables["actions"]
    np.testing.assert_array_equal(tstate["keys"].numpy(),
                                  np.asarray(jstate["keys"]))
    lifted = np.stack([np.asarray(jstate["cols"]["price"]),
                       np.ones(cap, np.float32)], axis=1)
    lifted[n:] = np.nan                # garbage past the live count
    b = 64
    qkey = rng.integers(0, 8, b).astype(np.int32)
    qt1 = rng.integers(0, 50_000, b).astype(np.int32)
    qt0 = qt1 - 60_000 // 4
    want = np.asarray(jax_swf(jstate, jnp.asarray(lifted), *map(
        jnp.asarray, (qkey, qt0, qt1))))
    got = store_windowfold(tstate, torch.from_numpy(lifted), *map(
        torch.from_numpy, (qkey, qt0, qt1))).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:, 1], np.rint(got[:, 1]))


def test_kernel_cannot_be_forced_on_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(64, 2, 3, seed=1)]
    with pytest.raises(dispatch.KernelUnsupportedError):
        batch_windowfold(*args, use_kernel=True)
    before = dict(dispatch.launch_counts())
    batch_windowfold(*args)
    assert dispatch.launch_counts() == before
