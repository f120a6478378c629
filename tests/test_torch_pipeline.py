"""Training-data pipelines, port against reference: the same script over
the same seeded tables through both packages' ``FeatureDataPipeline``,
and the same seeds through both ``TokenPipeline``s.  The feature matrix
and the first batches are equal bitwise, except the EW columns at
``EW_RTOL`` / ``EW_ATOL`` (the bar of ``tests/test_torch_offline.py``);
the port's batches are tensors on its device (here the CPU), drawn from
the same seeded ``default_rng`` indices as the reference's.  Token
batches are bitwise.
"""

import numpy as np
import pytest
import torch

from repro.core import compile_script as jax_compile
from repro.data.pipeline import FeatureDataPipeline as JaxPipeline
from repro.data.pipeline import TokenPipeline as JaxTokens
from repro.data.synthetic import make_action_tables as jax_tables
from repro_torch.core import compile_script
from repro_torch.data import FeatureDataPipeline, TokenPipeline
from repro_torch.data.synthetic import make_action_tables as torch_tables

from conftest import MICRO_SQL
from torch_port_cases import ACTION_TABLES, EW_ATOL, EW_RTOL

N_BATCHES = 5


def ew_columns(cs, feats) -> np.ndarray:
    """Which columns of the feature matrix hold an EW feature."""
    flags = []
    for name in cs.feature_names:
        v = np.asarray(feats[name])
        flags += [name.startswith("ew")] * (1 if v.ndim == 1 else v.shape[1])
    return np.asarray(flags)


def assert_rows_equal(got, want, ew):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got[:, ~ew], want[:, ~ew])
    np.testing.assert_allclose(got[:, ew], want[:, ew], rtol=EW_RTOL,
                               atol=EW_ATOL)


@pytest.fixture(scope="module")
def pipelines():
    jt, tt = jax_tables(**ACTION_TABLES), torch_tables(**ACTION_TABLES)
    ref = JaxPipeline(jax_compile(MICRO_SQL, tables=jt), jt, batch_size=16,
                      seed=3)
    port = FeatureDataPipeline(compile_script(MICRO_SQL, tables=tt), tt,
                               batch_size=16, seed=3, device="cpu")
    return ref, port


def test_feature_matrix_matches_reference(pipelines):
    ref, port = pipelines
    want, got = ref.feature_matrix(), port.feature_matrix()
    assert got.shape[0] == ACTION_TABLES["n_actions"]
    assert np.isfinite(got).all()
    assert_rows_equal(got, want, ew_columns(port.cs, port.materialize()))


def test_batches_match_reference(pipelines):
    """The first batches hold the reference's rows in its order: indices
    from the same seeded generator, labels from the same median."""
    ref, port = pipelines
    ew = ew_columns(port.cs, port.materialize())
    mat = port.feature_matrix()
    rng = np.random.default_rng(3)
    want = list(ref.batches(N_BATCHES))
    got = list(port.batches(N_BATCHES))
    assert len(got) == N_BATCHES
    for g, w in zip(got, want):
        feats, labels = g["features"], g["labels"]
        assert isinstance(feats, torch.Tensor) and feats.device.type == "cpu"
        assert labels.dtype == torch.int32
        assert_rows_equal(feats.numpy(), w["features"], ew)
        np.testing.assert_array_equal(labels.numpy(), w["labels"])
        idx = rng.integers(0, mat.shape[0], 16)
        np.testing.assert_array_equal(feats.numpy(), mat[idx])


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (5, 3)])
def test_token_batches_bitwise(seed, step):
    ref = JaxTokens(vocab_size=1000, batch_size=4, seq_len=32, seed=seed)
    port = TokenPipeline(vocab_size=1000, batch_size=4, seq_len=32,
                         seed=seed)
    got, want = port.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert [b["tokens"].tolist() for b in port.batches(2)] == \
        [b["tokens"].tolist() for b in ref.batches(2)]
