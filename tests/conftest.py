"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see 1 CPU device;
only launch/dryrun.py forces 512 virtual devices."""

import numpy as np
import pytest

from repro.data.synthetic import make_action_tables


@pytest.fixture(scope="session")
def action_tables():
    return make_action_tables(n_actions=300, n_orders=200, n_users=8,
                              horizon_ms=60_000, seed=0)


@pytest.fixture(scope="session")
def skewed_tables():
    return make_action_tables(n_actions=400, n_orders=0, n_users=12,
                              horizon_ms=120_000, zipf_alpha=1.3, seed=1,
                              with_profile=False)


MICRO_SQL = """
SELECT
  sum(price) OVER w3s AS price_sum,
  avg(price) OVER w3s AS price_avg,
  count(price) OVER w3s AS cnt,
  min(price) OVER w3s AS price_min,
  max(price) OVER w3s AS price_max,
  distinct_count(category) OVER w3s AS n_cat,
  topn_frequency(category, 3) OVER w3s AS topcat,
  avg_cate_where(price, quantity > 1, category) OVER w3s AS cate_avg,
  drawdown(price) OVER w100 AS dd,
  ew_avg(price, 0.5) OVER w100 AS ew,
  price * 2 AS double_price
FROM actions
WINDOW w3s AS (UNION orders PARTITION BY userid ORDER BY ts
               ROWS_RANGE BETWEEN 3s PRECEDING AND CURRENT ROW),
      w100 AS (PARTITION BY userid ORDER BY ts
               ROWS BETWEEN 100 PRECEDING AND CURRENT ROW)
"""


@pytest.fixture(scope="session")
def micro_sql():
    return MICRO_SQL


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (and nvcc or Triton); skips "
        "where there is none")
