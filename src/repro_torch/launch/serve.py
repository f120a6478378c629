"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Online Request Mode end to end (paper Figure 3): events are loaded into
the feature store; each request computes fresh features, and a token per
request joins a batch that runs greedy generation on the model
(``reduced(arch)``, random weights from seed 0).

As the reference's launcher (``repro/launch/serve.py``), it asks for one
request's features at a time (``FeatureEngine.request``), so the
feature TP50 / TP99 it prints count one latency sample per request, and
submits each token as it comes, running a batch whenever the batcher
is ready (``--batch-size`` tokens, or the oldest waited 2 ms).  Unlike
the reference, it then serves a tail the batcher still holds, so every
request is served.  Runs on the card unless ``--device cpu``.
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

    def serve_batch():
        ids, toks, n_real = batcher.next_batch(pad_with=0)
        prompt = np.asarray(toks, np.int32)[:, None]
        model.generate_greedy({"tokens": prompt}, n_tokens=4)
        return n_real

    for i in range(args.requests):
        f = feats.request(dict(a.row(i)))         # fresh features
        batcher.submit(int(f["n_events"]) % cfg.vocab_size)
        if batcher.ready():
            n_served += serve_batch()
    while batcher.queue:       # a tail short of a batch, before its wait
        n_served += serve_batch()
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
