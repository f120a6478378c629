"""Serving, port against reference: ``FeatureEngine(fused_fold=True)`` in
both packages over the same tables and requests.  The port's store is
filled two ways — carried over from the reference engine with
``load_store_from``, and by its own ``bulk_load`` + ``ingest_many`` — and
``request_batch`` must give the reference's features: bitwise on every
column except ``ew`` (rtol ``EW_RTOL``; an exp/log ulp carried by the EW
fold), ``cat_h`` (the feature-hash path) exact."""

import numpy as np
import pytest
import torch

import jax
from repro.serve.engine import FeatureEngine as JaxEngine
from repro_torch.data.synthetic import make_action_tables
from repro_torch.serve.engine import FeatureEngine as TorchEngine

from torch_port_cases import ACTION_TABLES, EW_ATOL, EW_RTOL, SMOKE_SQL

N_HIST = 150
BATCHES = (1, 5, 8)


@pytest.fixture(scope="module", params=["micro", "smoke"])
def engines(request, action_tables, micro_sql):
    sql = micro_sql if request.param == "micro" else SMOKE_SQL
    t_tables = make_action_tables(**ACTION_TABLES)
    je = JaxEngine(sql, action_tables, capacity=1024, fused_fold=True)
    own = TorchEngine(sql, t_tables, capacity=1024, fused_fold=True,
                      device="cpu")
    for eng, tables in ((je, action_tables), (own, t_tables)):
        eng.bulk_load("orders", tables["orders"])
        eng.ingest_many("actions", [tables["actions"].row(i)
                                    for i in range(N_HIST)])
    carried = TorchEngine(sql, t_tables, capacity=1024, fused_fold=True,
                          device="cpu")
    carried.load_store_from({t: jax.tree.map(np.asarray, st)
                             for t, st in je.store.tables.items()})
    rows = [dict(action_tables["actions"].row(N_HIST + i))
            for i in range(max(BATCHES))]
    return request.param, je, own, carried, rows


def _assert_features_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in w:
            a, b = np.asarray(w[k]), np.asarray(g[k])
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if k == "ew":
                np.testing.assert_allclose(b, a, rtol=EW_RTOL, atol=EW_ATOL)
            else:
                np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("b", BATCHES)
def test_request_batch_matches_reference(engines, b):
    which, je, own, carried, rows = engines
    want = je.request_batch(rows[:b])
    _assert_features_equal(want, carried.request_batch(rows[:b]))
    _assert_features_equal(want, own.request_batch(rows[:b]))
    if which == "smoke":
        assert all(0 <= f["cat_h"] < 1048576 for f in want)


def test_own_ingest_gives_the_reference_store(engines):
    _, je, own, _, _ = engines
    for t, st in je.store.tables.items():
        for k in ("keys", "ts", "count"):
            np.testing.assert_array_equal(own.store.tables[t][k].numpy(),
                                          np.asarray(st[k]))
        for c, v in st["cols"].items():
            np.testing.assert_array_equal(
                own.store.tables[t]["cols"][c].numpy(), np.asarray(v))


def test_submit_and_flush_match_request_batch(engines):
    _, _, own, _, rows = engines
    ids = [own.submit_request(r) for r in rows[:5]]
    out = own.flush()
    assert sorted(out) == ids
    _assert_features_equal(own.request_batch(rows[:5]),
                           [out[i] for i in ids])
    assert own.latency_percentiles()


def test_null_prices_served_like_the_reference(action_tables):
    """NaN is the system's NULL: history rows with a NULL price reach the
    window features over them (min and max propagate it; drawdown's
    state carries it) in both packages alike."""
    t_tables = make_action_tables(**ACTION_TABLES)

    def history(tables):
        rows = [dict(tables["actions"].row(i)) for i in range(N_HIST)]
        for r in rows[4::9]:
            r["price"] = float("nan")
        return rows

    je = JaxEngine(SMOKE_SQL, action_tables, capacity=1024, fused_fold=True)
    te = TorchEngine(SMOKE_SQL, t_tables, capacity=1024, fused_fold=True,
                     device="cpu")
    for eng, tables in ((je, action_tables), (te, t_tables)):
        eng.bulk_load("orders", tables["orders"])
        eng.ingest_many("actions", history(tables))
    rows = [dict(action_tables["actions"].row(N_HIST + i)) for i in range(8)]
    want = je.request_batch(rows)
    _assert_features_equal(want, te.request_batch(rows))
    for k in ("mn", "mx"):
        assert any(np.isnan(f[k]) for f in want), k


@pytest.mark.parametrize("option", [
    {"n_shards": 2}, {"replication": 1}, {"checkpoint_dir": "ckpt"}])
def test_unported_options_raise(option, micro_sql):
    kw = dict(capacity=64, fused_fold=True, device="cpu")
    kw.update(option)
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        TorchEngine(micro_sql, make_action_tables(**ACTION_TABLES), **kw)


def test_cuda_device_without_a_card_raises(micro_sql):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(micro_sql, make_action_tables(**ACTION_TABLES),
                    capacity=64, fused_fold=True)
