"""Quickstart on the PyTorch port: deploy a feature script once, use it
offline AND online (the port's counterpart of ``quickstart.py``).

This is the paper's Figure 1 scenario end-to-end:
  1. define the feature script (extended SQL with WINDOW UNION,
     topn_frequency, avg_cate_where, LAST JOIN),
  2. compile it ONCE (unified plan generator),
  3. offline mode: batch features over historical tables (training side),
  4. online mode: per-request features against the live store (serving),
  5. verify both agree.

Runs on the card (the unit fold and the feature hash are hand-written
kernels there) unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import compile_script, parse, verify_consistency
from repro_torch.data.synthetic import make_action_tables
from repro_torch.serve.engine import FeatureEngine

SQL = """
SELECT
  distinct_count(category) OVER w_union_3s AS product_count,
  avg_cate_where(price, quantity > 1, category)
      OVER w_union_3s AS product_prices,
  sum(price) OVER w_action_100d AS spend_100d,
  topn_frequency(category, 3) OVER w_action_100d AS favourite_products,
  profile.age AS age,
  price * quantity AS order_value
FROM actions
LAST JOIN profile ORDER BY ts ON actions.userid = profile.userid
WINDOW w_union_3s AS (UNION orders PARTITION BY userid ORDER BY ts
                      ROWS_RANGE BETWEEN 3s PRECEDING AND CURRENT ROW),
      w_action_100d AS (PARTITION BY userid ORDER BY ts
                        ROWS_RANGE BETWEEN 100d PRECEDING AND CURRENT ROW)
"""


def history():
    """The historical tables (actions / orders / profile)."""
    return make_action_tables(n_actions=400, n_orders=250, n_users=8,
                              horizon_ms=2_000_000)


def offline(device: str = "cuda", tables=None):
    """Step 3: the compiled script's offline features over the history."""
    tables = history() if tables is None else tables
    return compile_script(parse(SQL), tables=tables).offline(tables,
                                                             device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("== 1. historical tables (actions / orders / profile)")
    tables = history()
    for name, t in tables.items():
        print(f"   {name}: {t.n_rows} rows")

    print("== 2. compile the feature script (one plan, two drivers)")
    cs = compile_script(parse(SQL), tables=tables)
    print(cs.describe_plan())

    print(f"== 3. offline mode (training features) on {args.device}")
    feats = cs.offline(tables, device=args.device)
    for name, v in feats.items():
        print(f"   {name:20s} shape={v.shape} "
              f"sample={np.round(np.atleast_1d(v[0])[:3], 2)}")

    print("== 4. online request mode (serving features)")
    eng = FeatureEngine(SQL, tables, capacity=2048, device=args.device)
    eng.bulk_load("actions", tables["actions"])
    eng.bulk_load("orders", tables["orders"])
    eng.bulk_load("profile", tables["profile"])
    req = dict(tables["actions"].row(399))
    out = eng.request(req)
    for name, v in out.items():
        print(f"   {name:20s} = {np.round(np.atleast_1d(v)[:3], 2)}")
    print(f"   latency: {eng.latency_percentiles()}")

    print("== 5. offline/online consistency")
    report = verify_consistency(cs, tables, device=args.device)
    print(f"   {report}")
    assert report.passed
    return feats


if __name__ == "__main__":
    main()
