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


def test_inf_in_matched_and_unmatched_rows():
    """+Inf in a row request 0 matches gives it +Inf; every request that
    does not match it reads 0 * Inf = NaN in that lane (the dense
    product), and a -Inf in a row no request matches turns its lane NaN
    for all: the port's plain version and the reference alike."""
    keys, ts, vals, qkey, qt0, qt1 = _inputs(300, 3, 12, seed=8)
    qkey[0], qt1[0], qt0[0] = keys[7], ts[7], ts[7] - 100
    hit = np.flatnonzero((keys == qkey[0]) & (ts >= qt0[0]) & (ts <= qt1[0]))
    assert hit.size
    vals[hit[0], 0] = np.inf
    keys[-1] = 99                      # matches no request key
    vals[-1, 2] = -np.inf
    want_ref, want_pal, got = _both((keys, ts, vals, qkey, qt0, qt1))
    for want in (want_ref, want_pal):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert got[0, 0] == np.inf
    assert np.all(np.isnan(got[:, 0]) | (got[:, 0] == np.inf))
    assert np.isnan(got[:, 2]).all() and np.isfinite(got[:, 1]).all()


def _dense_design(keys, ts, vals, qkey, qt0, qt1, chunk):
    """The dense kernel's arithmetic: per chunk acc = acc + m * v over
    every row in row order, then the partials in chunk order."""
    out = np.zeros((qkey.shape[0], vals.shape[1]), np.float32)
    for lo in range(0, keys.shape[0], chunk):
        acc = np.zeros_like(out)
        for i in range(lo, min(keys.shape[0], lo + chunk)):
            m = ((keys[i] == qkey) & (ts[i] >= qt0) & (ts[i] <= qt1))
            with np.errstate(invalid="ignore"):
                acc = acc + m.astype(np.float32)[:, None] * vals[i][None, :]
        out = out + acc
    return out


def _skipping_design(keys, ts, vals, qkey, qt0, qt1, chunk, group):
    """The redesigned kernel's arithmetic: a request whose (key, ts)
    interval misses a chunk's range writes +0.0, or NaN in a lane with a
    non-finite value there; otherwise it folds only the 32-row groups in
    its range or holding a non-finite value, and the nonzero partials
    are added in chunk order."""
    pack = keys.astype(np.int64) * 2**32 + (ts.astype(np.int64) + 2**31)
    lo_q = qkey.astype(np.int64) * 2**32 + (qt0.astype(np.int64) + 2**31)
    hi_q = qkey.astype(np.int64) * 2**32 + (qt1.astype(np.int64) + 2**31)
    out = np.zeros((qkey.shape[0], vals.shape[1]), np.float32)
    for lo in range(0, keys.shape[0], chunk):
        rows = np.arange(lo, min(keys.shape[0], lo + chunk))
        bad = ~np.isfinite(vals[rows])
        for b in range(qkey.shape[0]):
            if lo_q[b] > pack[rows].max() or hi_q[b] < pack[rows].min():
                part = np.where(bad.any(0), np.float32(np.nan),
                                np.float32(0))
            else:
                part = np.zeros(vals.shape[1], np.float32)
                for g in range(lo, rows[-1] + 1, group):
                    gr = np.arange(g, min(rows[-1] + 1, g + group))
                    if not bad[gr - lo].any() and (
                            lo_q[b] > pack[gr].max()
                            or hi_q[b] < pack[gr].min()):
                        continue
                    for i in gr:
                        m = np.float32(keys[i] == qkey[b] and
                                       qt0[b] <= ts[i] <= qt1[b])
                        with np.errstate(invalid="ignore"):
                            part = part + m * vals[i]
            nz = part.view(np.int32) != 0
            out[b, nz] = out[b, nz] + part[nz]
    return out


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_skipping_rows_keeps_the_dense_designs_bits(sort):
    """The kernel skips chunks and groups a request cannot match and adds
    only nonzero partials: because a fold from +0.0 is never -0.0, adding
    m * v = +-0.0 changes nothing, and a non-finite value in an
    unmatched row still makes NaN, so the result is the dense design's,
    bit for bit, on a sorted store and an unsorted one (small chunks and
    groups, the kernel's rule)."""
    keys, ts, vals, qkey, qt0, qt1 = _inputs(700, 2, 9, seed=12)
    if sort:
        order = np.lexsort((ts, keys))
        keys, ts, vals = keys[order], ts[order], vals[order]
    vals[5, 0] = np.nan                # unmatched: its lane turns NaN
    qkey[1], qt1[1], qt0[1] = keys[400], ts[400], ts[400] - 2_000
    hit = np.flatnonzero((keys == qkey[1]) & (ts >= qt0[1]) & (ts <= qt1[1]))
    vals[hit[-1], 1] = np.inf
    args = (keys, ts, vals, qkey, qt0, qt1)
    want = _dense_design(*args, chunk=128)
    got = _skipping_design(*args, chunk=128, group=16)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(got)
    np.testing.assert_array_equal(got[ok].view(np.int32),
                                  want[ok].view(np.int32))
