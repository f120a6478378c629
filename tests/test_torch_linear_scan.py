"""The linear recurrence y_t = a_t * y_{t-1} + b_t, port against
reference on the same numpy inputs.

The port's plain version is the exact sequential recurrence (its
``ref.py`` fixes that bracketing, and the CUDA kernel repeats it bit for
bit on the card), so it equals a numpy loop bitwise.  Against the
reference's Pallas kernel (interpret mode) and its associative-scan
``ref.py``, which bracket the same sums otherwise, rtol/atol 1e-4, the
reference's own bar (``tests/test_kernels.py``); against the sequential
oracle of that test, 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunked_scan.kernel import linear_scan_pallas
from repro.kernels.chunked_scan.ref import linear_scan_ref as jax_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.chunked_scan import linear_scan
from repro_torch.kernels.chunked_scan.ops import pad_to_chunk

RTOL = ATOL = 1e-4
SHAPES = [(1, 64, 8, 16), (2, 300, 32, 128), (3, 128, 1, 128),
          (2, 1000, 7, 64)]


def _inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 1.0, (b, t, d)).astype(np.float32),
            rng.standard_normal((b, t, d)).astype(np.float32))


def _sequential(a, x):
    h = np.zeros(a.shape[:-2] + a.shape[-1:], np.float32)
    y = np.empty_like(x)
    for i in range(a.shape[-2]):
        h = a[..., i, :] * h + x[..., i, :]
        y[..., i, :] = h
    return y


@pytest.mark.parametrize("b,t,d,chunk", SHAPES)
def test_plain_matches_pallas_and_ref(b, t, d, chunk):
    a, x = _inputs(b, t, d, t)
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(x),
                      chunk=chunk).numpy()
    pad = (-t) % chunk
    ap = np.concatenate([a, np.ones((b, pad, d), np.float32)], axis=1)
    xp = np.concatenate([x, np.zeros((b, pad, d), np.float32)], axis=1)
    pal = np.asarray(linear_scan_pallas(jnp.asarray(ap), jnp.asarray(xp),
                                        chunk=chunk, interpret=True))[:, :t]
    ref = np.asarray(jax_ref(jnp.asarray(a), jnp.asarray(x)))
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got, _sequential(a, x))


@pytest.mark.parametrize("t,d", [(2, 1), (17, 3), (80, 9), (129, 5)])
def test_against_sequential_oracle(t, d):
    """The reference test's oracle (2e-3), and bitwise against the same
    recurrence in numpy float32."""
    rng = np.random.default_rng(t * 100 + d)
    a = rng.uniform(0.2, 0.99, (1, t, d)).astype(np.float32)
    x = rng.standard_normal((1, t, d)).astype(np.float32)
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    h = np.zeros((d,), np.float32)
    for i in range(t):
        h = a[0, i] * h + x[0, i]
        np.testing.assert_allclose(got[0, i], h, rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(got[0, i], h)


@pytest.mark.parametrize("t,chunk", [(1, 128), (100, 128), (300, 128),
                                     (129, 64), (64, 16)])
def test_padding_to_the_chunk_is_a_no_op(t, chunk):
    """The kernel path pads T to a multiple of the chunk with a = 1,
    b = 0 and slices the padding off: the same bits as the unpadded
    scan, and a state that the padding leaves as it was."""
    a, x = (torch.from_numpy(v) for v in _inputs(2, t, 6, t + chunk))
    ap, xp = pad_to_chunk(a, x, chunk)
    assert ap.shape[1] % chunk == 0 and ap.shape[1] - t < chunk
    assert torch.equal(ap[:, :t], a) and torch.equal(xp[:, :t], x)
    assert bool((ap[:, t:] == 1).all()) and bool((xp[:, t:] == 0).all())
    want = linear_scan(a, x)
    padded = linear_scan(ap, xp)
    assert torch.equal(padded[:, :t], want)
    assert torch.equal(padded[:, -1], want[:, -1])


def test_two_dimensional_input_and_dtype():
    a, x = _inputs(1, 50, 4, 0)
    got = linear_scan(torch.from_numpy(a[0]).double(),
                      torch.from_numpy(x[0]))
    assert got.dtype == torch.float32 and got.shape == (50, 4)
    np.testing.assert_array_equal(got.numpy(), _sequential(a, x)[0])


def test_kernel_on_a_cpu_tensor_raises():
    a, x = (torch.from_numpy(v) for v in _inputs(1, 8, 2, 0))
    with pytest.raises(dispatch.KernelUnsupportedError):
        linear_scan(a, x, use_kernel=True)
    with pytest.raises(ValueError, match="power of two"):
        linear_scan(a, x, chunk=96)
