"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Online Request Mode end to end (paper Figure 3): events are loaded into
the feature store; each request computes fresh features, and a token per
request joins a batch that runs greedy generation on the model
(``reduced(arch)``, random weights from seed 0).

The reference driver (``repro/launch/serve.py``) asks for one request's
features at a time (``FeatureEngine.request``); the port's single-row
``request`` is not ported yet (ROADMAP queue 1, item 2), so this driver
calls ``request_batch`` over each batch's rows, which gives the same
features row for row.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import reduced
from ..data.synthetic import make_action_tables
from ..models import init_params
from ..serve.batcher import RequestBatcher
from ..serve.engine import FeatureEngine, ServingEngine

SQL = """
SELECT
  sum(price) OVER w AS spend_60s,
  count(price) OVER w AS n_events,
  distinct_count(category) OVER w AS n_categories,
  topn_frequency(category, 3) OVER w AS top_categories
FROM actions
WINDOW w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW)
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    tables = make_action_tables(n_actions=2000, n_orders=1000,
                                with_profile=False)
    feats = FeatureEngine(SQL, tables, capacity=8192, fused_fold=True,
                          device=args.device)
    feats.bulk_load("actions", tables["actions"])
    feats.bulk_load("orders", tables["orders"])

    cfg = reduced(args.arch)
    dev = feats.device
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.float32, device=dev)
    model = ServingEngine(cfg, params, max_len=64, dtype=torch.float32,
                          device=dev)
    batcher = RequestBatcher(args.batch_size, max_wait_ms=2.0)

    a = tables["actions"]
    n_served = 0
    t0 = time.time()
    for lo in range(0, args.requests, args.batch_size):
        rows = [dict(a.row(i)) for i in
                range(lo, min(lo + args.batch_size, args.requests))]
        for f in feats.request_batch(rows):       # fresh features
            batcher.submit(int(f["n_events"]) % cfg.vocab_size)
        while batcher.ready():
            ids, toks, n_real = batcher.next_batch(pad_with=0)
            prompt = np.asarray(toks, np.int32)[:, None]
            model.generate_greedy({"tokens": prompt}, n_tokens=4)
            n_served += n_real
    dt = time.time() - t0
    pct = feats.latency_percentiles()
    print(f"[serve] {n_served} requests in {dt:.1f}s "
          f"feature TP50={pct.get('TP50', 0):.2f}ms "
          f"TP99={pct.get('TP99', 0):.2f}ms "
          f"batches={batcher.batches_emitted} "
          f"padded={batcher.padded_slots}")
    return n_served


if __name__ == "__main__":
    main()
