"""Feature-signature hashing, port against reference: exact, including
negative codes and codes at the int32 extremes.  The JAX side runs the
Pallas kernel in interpret mode and its jnp reference; the port runs its
plain version on the CPU.  The Triton kernel is held to the plain
version on the card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.feature_hash import ops as jax_fh
from repro_torch.kernels import dispatch
from repro_torch.kernels.feature_hash import ops as torch_fh
from repro_torch.kernels.feature_hash.ref import feature_hash_ref

EXTREMES = [0, 1, -1, 2, -2, 2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1,
            0x7FFF0000, -0x10000]


def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    flat = codes.reshape(-1)
    flat[:len(EXTREMES)] = EXTREMES[:flat.size]
    return codes.astype(np.int32)


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas-interpret", "jnp-ref"])
@pytest.mark.parametrize("shape,dim", [((64,), 1024), ((16, 7), 1 << 20),
                                       ((3, 5, 2), 997), ((257,), 1)])
def test_hash_matches_reference_exactly(use_pallas, shape, dim):
    codes = _codes(shape, seed=dim)
    want = np.asarray(jax_fh.feature_hash(jnp.asarray(codes), dim,
                                          use_pallas=use_pallas,
                                          interpret=True))
    got = torch_fh.feature_hash(torch.from_numpy(codes), dim).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < dim)).all()


def test_hash_custom_salt():
    codes = _codes((128,), seed=3)
    for salt in (0, 1, 0xFFFFFFFF):
        want = np.asarray(jax_fh.feature_hash(jnp.asarray(codes), 4096,
                                              salt=salt, use_pallas=False))
        got = feature_hash_ref(torch.from_numpy(codes), 4096, salt=salt)
        np.testing.assert_array_equal(got.numpy(), want)


def test_forcing_kernel_on_cpu_raises():
    with pytest.raises(dispatch.KernelUnsupportedError):
        torch_fh.feature_hash(torch.zeros(4, dtype=torch.int32), 16,
                              use_kernel=True)
