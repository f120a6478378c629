"""Shared inputs of the port's parity tests (``test_torch_*.py``): the
scripts both packages compile, the table sizes both packages generate
from one seed, and the card check the GPU-marked tests make at run
time (never at import, so every xdist worker collects the same tests).
"""

import numpy as np
import pytest
import torch

SMOKE_SQL = """
SELECT
  sum(price) OVER w AS s, avg(price) OVER w AS a,
  count(price) OVER w AS c, min(price) OVER w AS mn,
  max(price) OVER w AS mx,
  distinct_count(category) OVER w AS dc,
  drawdown(price) OVER wr AS dd,
  ew_avg(price, 0.5) OVER wr AS ew,
  discrete(category, 1048576) AS cat_h
FROM actions
WINDOW w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW),
  wr AS (PARTITION BY userid ORDER BY ts
         ROWS BETWEEN 100 PRECEDING AND CURRENT ROW)
"""

# the ``action_tables`` fixture's arguments (tests/conftest.py)
ACTION_TABLES = dict(n_actions=300, n_orders=200, n_users=8,
                     horizon_ms=60_000, seed=0)

# XLA and torch may differ by an ulp in exp/log, and the EW fold carries
# that through its decay products: the reference's own kernel tests hold
# EW at this bar (tests/test_kernels.py, tests/test_online_batch.py)
EW_RTOL, EW_ATOL = 1e-5, 1e-6


def require_cuda() -> torch.device:
    """Skip the calling test where there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers it on the "
                    "card")
    return torch.device("cuda")


# every combine family (add, min, max, drawdown, ew) x frame shape
# (ROWS_RANGE, ROWS, MAXSIZE, EXCLUDE CURRENT_ROW), plus the HLL sketch
# leaf riding the max stack
FAMILY_SQL = """
SELECT
  sum(price) OVER w3s AS s_price, avg(price) OVER w3s AS a_price,
  count(price) OVER w3s AS c_price, min(price) OVER w3s AS mn_price,
  max(price) OVER w3s AS mx_price,
  distinct_count(item) OVER w3s AS dc_item,
  topn_frequency(item, 3) OVER w3s AS topn_item,
  avg_cate_where(price, item, price > 1.0) OVER w3s AS acw,
  drawdown(price) OVER wr AS dd_price,
  ew_avg(price, 0.5) OVER wr AS ew_price,
  sum(price) OVER wx AS s_price_x,
  min(price) OVER wm AS mn_price_m
FROM actions
WINDOW w3s AS (PARTITION BY uid ORDER BY ts
               ROWS_RANGE BETWEEN 3s PRECEDING AND CURRENT ROW),
  wr AS (PARTITION BY uid ORDER BY ts
         ROWS BETWEEN 50 PRECEDING AND CURRENT ROW),
  wx AS (PARTITION BY uid ORDER BY ts
         ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW
         MAXSIZE 7 EXCLUDE CURRENT_ROW),
  wm AS (PARTITION BY uid ORDER BY ts
         ROWS BETWEEN 10 PRECEDING AND CURRENT ROW MAXSIZE 4)
"""

EDGE_SQL = """
SELECT sum(price) OVER wa AS s, min(price) OVER wa AS mn,
       sum(price) OVER wb AS sb
FROM actions
WINDOW wa AS (PARTITION BY uid ORDER BY ts
              ROWS BETWEEN 5 PRECEDING AND CURRENT ROW),
  wb AS (PARTITION BY uid ORDER BY ts
         ROWS_RANGE BETWEEN 2s PRECEDING AND CURRENT ROW)
"""

SOLO_SQL = """
SELECT sum(price) OVER wa AS s
FROM actions
WINDOW wa AS (PARTITION BY uid ORDER BY ts
              ROWS BETWEEN 5 PRECEDING AND CURRENT ROW)
"""

SQLS = {"family": FAMILY_SQL, "edge": EDGE_SQL, "solo": SOLO_SQL}
HLL = dict(distinct_hll_p=4, distinct_hll_min_card=8)


def unit_block(u, r, seed, n_valid=None, nan_rows=()):
    """(U, R) unit columns: sorted timestamps, a valid prefix per unit
    (``n_valid[i]`` rows; 0 = an empty unit), garbage in invalid slots.
    ``nan_rows`` lists (unit, row) cells whose price is NULL (NaN)."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 20_000, (u, r)), axis=1).astype(np.int32)
    price = rng.normal(2.0, 1.5, (u, r)).astype(np.float32)
    item = rng.integers(0, 9, (u, r)).astype(np.int32)
    nv = (rng.integers(1, r + 1, u) if n_valid is None
          else np.asarray(n_valid))
    valid = np.arange(r)[None, :] < nv[:, None]
    price[~valid] = 99.0
    for i, j in nan_rows:
        price[i, j] = np.nan
    return {"ts": ts, "price": price, "item": item, "__valid__": valid}
