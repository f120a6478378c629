"""CI gate of the PyTorch port: serving-loop record/replay determinism
+ offline parity (the port's counterpart of ``check_replay.py``).

Three layers, in one run over a mixed request/ingest trace with
mid-trace retention eviction and compaction, on ``--device`` (the card
unless ``--device cpu``):

  * **replay-vs-replay** — the recorded trace, round-tripped through
    JSON, is replayed twice through fresh engines; every served feature
    array AND every leaf of the final store state must be bitwise
    identical (``np.array_equal``).
  * **recorded-vs-replayed** — the replayed outputs must also match the
    original recording run byte for byte.
  * **serving-vs-offline** — the replayed outputs, reordered to offline
    row order, must pass ``verify_consistency(bitwise=True)`` against
    ``cs.offline(tables)``.

Prices are floored to integer-valued f32 so the float sums stay exact
through the eviction anchor move; the engine runs ``retention="auto"``
with a small ``compact_every`` so eviction fires inside the trace — the
run aborts if it did not.

    PYTHONPATH=src python tools/torch_check_replay.py [--device cpu] \\
        [n_actions]
"""

from __future__ import annotations

import sys
import tempfile

try:
    from tools.torch_common import RAW_SQL, device_argv, int_prices, \
        tail_int_argv
except ImportError:                      # invoked as `python tools/x.py`
    from torch_common import RAW_SQL, device_argv, int_prices, tail_int_argv

import numpy as np  # noqa: E402

from repro_torch.core import verify_consistency  # noqa: E402
from repro_torch.data.synthetic import make_action_tables  # noqa: E402
from repro_torch.serve.engine import FeatureEngine  # noqa: E402
from repro_torch.serve.trace import (load_trace,  # noqa: E402
                                     outputs_in_base_order,
                                     record_consistency_trace, replay,
                                     save_trace, store_state_arrays)

REPLAY_KW = dict(batch_size=1, max_wait_ms=0.0, slo_ms=1e6)


def _arrays_equal(a, b, what: str) -> bool:
    for k in a:
        if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
            print(f"replay: FAIL {what} feature {k!r} differs")
            return False
    return True


def main(n_actions: int = 90, device: str = "cuda") -> int:
    tables = int_prices(make_action_tables(
        n_actions=n_actions, n_orders=0, n_users=4, horizon_ms=600_000,
        seed=7, with_profile=False))

    def factory():
        return FeatureEngine(RAW_SQL, tables, capacity=256,
                             retention="auto", compact_every=16,
                             device=device)

    eng = factory()
    loop0, events, rids = record_consistency_trace(eng, tables)
    evicted = n_actions - eng.store.n_rows("actions")
    if evicted <= 0:
        print("replay: FAIL trace produced no eviction — gate is vacuous")
        return 1

    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        save_trace(events, f.name)
        events2 = load_trace(f.name)
    lp1 = replay(events2, factory, **REPLAY_KW)
    lp2 = replay(events2, factory, **REPLAY_KW)

    cs = eng.cs
    out0 = outputs_in_base_order(loop0, rids, tables, cs)
    out1 = outputs_in_base_order(lp1, rids, tables, cs)
    out2 = outputs_in_base_order(lp2, rids, tables, cs)

    ok = _arrays_equal(out1, out2, "replay-vs-replay")
    st1, st2 = store_state_arrays(lp1.engine), store_state_arrays(lp2.engine)
    for (pa, xa), (pb, xb) in zip(st1, st2):
        if pa != pb or not np.array_equal(xa, xb):
            print(f"replay: FAIL final store leaf {pa} differs")
            ok = False
            break
    if ok:
        print(f"replay    : {len(events2)} events, {n_actions} requests, "
              f"{evicted} rows evicted mid-trace -> replay x2 "
              f"BITWISE-EQUAL ({len(st1)} store leaves)")

    ok2 = _arrays_equal(out0, out1, "recorded-vs-replayed")
    if ok2:
        print(f"recorded  : replay reproduces the recording run byte for "
              f"byte ({n_actions}x{len(out0)} features)")
    ok &= ok2

    rep = verify_consistency(cs, tables, bitwise=True,
                             online_outputs=out1, device=device)
    print(f"offline   : {rep}")
    ok &= rep.passed and rep.bitwise_equal
    return 0 if ok else 1


if __name__ == "__main__":
    dev, rest = device_argv()
    sys.exit(main(tail_int_argv(rest, 90)[0], device=dev))
