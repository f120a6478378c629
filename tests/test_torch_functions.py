"""Feature functions, port against reference, where the two packages once
differed: ``avg_cate`` with NULL values, ``stddev`` / ``variance``, and
``log1p``.

* ``avg_cate(value, category)`` keeps a NULL value in its own category
  (the reference's jit turns ``convert(hit) * w`` into ``select(hit, w,
  0)``); ``avg_cate_where`` spreads it over every category in both
  packages, because the condition's multiply blocks that rewrite.
* ``stddev`` / ``variance`` round ``q - mean*mean`` once, as the one
  fused multiply-add the reference's jit makes of it, and ``stddev``'s
  square root is correctly rounded: bitwise against the reference.
* ``log1p`` differs from XLA's by one ulp on some rows: its column is
  held at ``LOG1P_RTOL``.

Every column not named above is bitwise; ``ew`` columns at ``EW_RTOL``.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile_script as jax_compile
from repro.data.synthetic import make_action_tables as jax_tables
from repro.serve.engine import FeatureEngine as JaxEngine
from repro_torch.core import compile_script as torch_compile
from repro_torch.core.functions import _sub_square
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.serve.engine import FeatureEngine as TorchEngine

from torch_port_cases import EW_ATOL, EW_RTOL

LOG1P_RTOL = 1e-6        # one ulp of XLA's log1p against torch's
NULL_ROW = 17
TABLES = dict(n_actions=200, n_orders=0, n_users=4, horizon_ms=1_000_000,
              seed=4)

# tests/test_fold_engine.py's raw aggregate pool
RAW_AGGS = [
    "sum(price)", "avg(price)", "count(price)", "min(price)",
    "max(price)", "stddev(price)", "variance(price)",
    "distinct_count(category)", "topn_frequency(category, 3)",
    "drawdown(price)", "ew_avg(price, 0.5)",
    "avg_cate_where(price, quantity > 1, category)",
]
FRAMES = {"rows": "ROWS BETWEEN 9 PRECEDING AND CURRENT ROW",
          "range": "ROWS_RANGE BETWEEN 10s PRECEDING AND CURRENT ROW"}


def _sql(aggs, frame):
    sel = ",\n  ".join(f"{a} OVER w AS f{i}" for i, a in enumerate(aggs))
    return (f"SELECT\n  {sel},\n  log1p(price) AS lp\nFROM actions\n"
            f"WINDOW w AS (PARTITION BY userid ORDER BY ts {FRAMES[frame]})")


CATE_SQL = """
SELECT avg_cate(price, category) OVER w AS ac,
  avg_cate_where(price, quantity > 1, category) OVER w AS acw,
  stddev(price) OVER w AS sd, variance(price) OVER w AS va
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS BETWEEN 9 PRECEDING AND CURRENT ROW)
"""


def _tables(null_row=NULL_ROW):
    jt, tt = jax_tables(**TABLES), torch_tables(**TABLES)
    for t in (jt, tt):
        if null_row is not None:
            t["actions"].columns["price"][null_row] = np.nan
    return jt, tt


def _assert_equal(want, got, loose=()):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape, k
        if k == "lp":
            np.testing.assert_allclose(b, a, rtol=LOG1P_RTOL, err_msg=k)
        elif k in loose:
            np.testing.assert_allclose(b, a, rtol=EW_RTOL, atol=EW_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_avg_cate_keeps_a_null_in_its_category_offline():
    jt, tt = _tables()
    want = jax_compile(CATE_SQL, tables=jt).offline(jt)
    got = torch_compile(CATE_SQL, tables=tt).offline(tt, device="cpu")
    nan_ac = int(np.isnan(want["ac"]).sum())
    assert 0 < nan_ac < want["ac"].size // 4
    assert int(np.isnan(got["ac"]).sum()) == nan_ac
    # avg_cate_where spreads the NaN over every category, in both
    nan_acw = int(np.isnan(want["acw"]).sum())
    assert nan_acw > nan_ac
    assert int(np.isnan(got["acw"]).sum()) == nan_acw
    _assert_equal(want, got)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_avg_cate_and_variance_requests_match_reference(fused):
    jt, tt = _tables()
    je = JaxEngine(CATE_SQL, jt, capacity=512, fused_fold=fused)
    te = TorchEngine(CATE_SQL, tt, capacity=512, fused_fold=fused,
                     device="cpu")
    for eng, t in ((je, jt), (te, tt)):
        eng.ingest_many("actions", [t["actions"].row(i) for i in range(40)])
    rows = [dict(jt["actions"].row(40 + i)) for i in range(8)]
    for w, g in zip(je.request_batch(rows), te.request_batch(rows)):
        _assert_equal(w, g)


def test_negative_weight_gives_positive_zero_elsewhere():
    jt, tt = _tables(null_row=None)
    for t in (jt, tt):
        t["actions"].columns["price"][:] *= -1.0
    want = jax_compile(CATE_SQL, tables=jt).offline(jt)["ac"]
    got = torch_compile(CATE_SQL, tables=tt).offline(tt, device="cpu")["ac"]
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_raw_aggregates_match_reference(frame):
    """stddev and variance bitwise among every aggregate of the pool,
    NULL price included; log1p at its stated tolerance."""
    sql = _sql(RAW_AGGS, frame)
    jt, tt = _tables()
    want = jax_compile(sql, tables=jt).offline(jt)
    got = torch_compile(sql, tables=tt).offline(tt, device="cpu")
    ew = {f"f{i}" for i, a in enumerate(RAW_AGGS) if a.startswith("ew")}
    _assert_equal(want, got, loose=ew)


def _exact_f32(q: float, m: float) -> np.float32:
    """q - m*m of float32 inputs, rounded once to float32 (nearest, ties
    to even), from the exact rational value."""
    exact = Fraction(float(q)) - Fraction(float(m)) ** 2
    c = np.float32(float(exact))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        err = abs(Fraction(float(cand)) - exact)
        even = int(np.asarray(cand).view(np.int32)) % 2 == 0
        key = (err, not even)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def test_sub_square_rounds_once():
    """``_sub_square`` against the exact value rounded once and against
    the reference's jitted ``q - square(m)`` (one fused multiply-add), on
    pairs chosen so that ``q - m*m`` cancels (where a second rounding
    would show) and on random pairs."""
    rng = np.random.default_rng(0)
    m = rng.normal(3.0, 20.0, 2000).astype(np.float32)
    q = (m.astype(np.float64) ** 2 * (1.0 + rng.normal(0, 1e-6, 2000))
         ).astype(np.float32)
    q[:500] = rng.uniform(0, 500, 500).astype(np.float32)
    got = _sub_square(torch.from_numpy(q), torch.from_numpy(m)).numpy()
    ref = np.asarray(jax.jit(lambda a, b: a - jnp.square(b))(q, m))
    np.testing.assert_array_equal(got, ref)
    for i in range(0, 2000, 7):
        assert got[i] == _exact_f32(q[i], m[i]), (q[i], m[i])
    # the float32 form with two roundings differs on these cancelling
    # pairs, which is why the finalizer rounds once
    assert np.sum(q - np.square(m) != ref) > 0
