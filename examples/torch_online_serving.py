"""End-to-end online ML serving on the PyTorch port — the paper's
production shape (the port's counterpart of ``online_serving.py``).

Event streams feed the online store (with pre-aggregation for the long
window); each incoming request computes fresh features and scores them
with a served LM (batched greedy decode through the decode-attention
kernel on the card).  Runs on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_online_serving.py \
          [--device cpu] [--events N]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import reduced
from repro_torch.data.synthetic import make_action_tables
from repro_torch.models import init_params
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.engine import FeatureEngine, ServingEngine

SQL = """
SELECT
  sum(price) OVER w_recent AS spend_recent,
  count(price) OVER w_recent AS n_recent,
  avg(price) OVER w_long AS avg_long,
  max(price) OVER w_long AS max_long
FROM actions
WINDOW w_recent AS (UNION orders PARTITION BY userid ORDER BY ts
                    ROWS_RANGE BETWEEN 60s PRECEDING AND CURRENT ROW),
      w_long AS (PARTITION BY userid ORDER BY ts
                 ROWS_RANGE BETWEEN 2000s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "w_long:100s")
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", type=int, default=300,
                    help="streamed action rows (a request every third)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    print(f"== setup: stores + pre-aggregation + model on {dev}")
    tables = make_action_tables(n_actions=1200, n_orders=600, n_users=16,
                                horizon_ms=3_000_000, with_profile=False)
    feats = FeatureEngine(SQL, tables, capacity=4096, use_preagg=True,
                          ttl_ms=0, device=dev)
    cfg = reduced("qwen3-8b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    model = ServingEngine(cfg, params, max_len=64, dtype=torch.float32,
                          device=dev)
    batcher = RequestBatcher(batch_size=4, max_wait_ms=2.0)

    a, o = tables["actions"], tables["orders"]
    print("== stream: interleave ingest + requests")
    scored = 0
    for i in range(args.events):
        feats.ingest("actions", a.row(i))
        if i % 2 == 0:
            feats.ingest("orders", o.row(i))
        if i % 3 == 0:
            f = feats.request(dict(a.row(i)))
            tok = int(f["n_recent"]) % cfg.vocab_size
            batcher.submit(tok)
        if batcher.ready():
            _, toks, n_real = batcher.next_batch(pad_with=0)
            prompt = np.asarray(toks, np.int32)[:, None]
            model.generate_greedy({"tokens": prompt}, n_tokens=4)
            scored += n_real
    pct = feats.latency_percentiles()
    print(f"== done: {feats.n_requests} feature requests, "
          f"{scored} model scorings")
    print(f"   feature latency TP50={pct['TP50']:.2f}ms "
          f"TP99={pct['TP99']:.2f}ms (paper targets: 4-20ms)")
    print(f"   decode batches={batcher.batches_emitted}, "
          f"padding={batcher.padded_slots}")
    return feats.n_requests, scored


if __name__ == "__main__":
    main()
