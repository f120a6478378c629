"""CI gate of the PyTorch port: kill-shard -> promote -> bitwise parity
vs unsharded serving (the port's counterpart of ``check_recovery.py``).

Two layers of the same contract, on ``--device`` (the card unless
``--device cpu``):

  * ``verify_consistency(..., replication=1, kill_shard_at=k)`` — the
    offline reference never sees the fault while the online replay
    kills the owner shard of request k mid-traffic and fails over to a
    follower; the report must still be bitwise (raw serving always,
    pre-agg on integer-valued prices where every combine bracketing is
    f32-exact).
  * engine-level ``kill_shard``/``heal`` on ``FeatureEngine`` with
    traffic continuing while the shard is dead, gated ``array_equal``
    per feature against an unsharded engine fed identical rows.

    PYTHONPATH=src python tools/torch_check_recovery.py [--device cpu] \\
        [n_shards]
"""

from __future__ import annotations

import sys

try:
    from tools.torch_common import (PREAGG_SQL, RAW_SQL, device_argv,
                                    int_prices, tail_int_argv)
except ImportError:                      # invoked as `python tools/x.py`
    from torch_common import (PREAGG_SQL, RAW_SQL, device_argv, int_prices,
                              tail_int_argv)

import numpy as np  # noqa: E402

from repro_torch.core import compile_script, parse, verify_consistency  # noqa
from repro_torch.data.synthetic import make_action_tables  # noqa: E402
from repro_torch.serve.engine import FeatureEngine  # noqa: E402


def _engine_gate(n_shards: int, device: str) -> bool:
    tables = make_action_tables(n_actions=220, n_orders=0, n_users=8,
                                horizon_ms=12_000_000, seed=21,
                                with_profile=False)
    ref = FeatureEngine(RAW_SQL, tables, capacity=1024, device=device)
    rep = FeatureEngine(RAW_SQL, tables, capacity=1024,
                        n_shards=n_shards, replication=1, ship_every=32,
                        device=device)
    a = tables["actions"]
    rows = [a.row(i) for i in range(180)]
    ref.ingest_many("actions", rows[:120])
    rep.ingest_many("actions", rows[:120])
    rep.kill_shard(1)
    ref.ingest_many("actions", rows[120:])   # traffic while dead
    rep.ingest_many("actions", rows[120:])
    recs = rep.heal()
    probe = [a.row(190 + i) for i in range(12)]
    r1 = ref.request_batch([dict(r) for r in probe])
    r2 = rep.request_batch([dict(r) for r in probe])
    for i in range(len(probe)):
        for k in r1[i]:
            if not np.array_equal(np.asarray(r1[i][k]),
                                  np.asarray(r2[i][k])):
                print(f"engine    (S={n_shards}): FAIL req {i} "
                      f"feature {k}")
                return False
    rec = recs[0]
    print(f"engine    (S={n_shards}): kill shard 1 -> promote replica "
          f"{rec.replica}, replay {rec.replayed_entries} entries, "
          f"recover {rec.recovery_s * 1e3:.1f}ms -> BITWISE-EQUAL "
          f"({len(probe)}x{len(r1[0])} features)")
    return True


def main(n_shards: int = 4, device: str = "cuda") -> int:
    ok = True

    tables = make_action_tables(n_actions=150, n_orders=0, n_users=6,
                                seed=11, with_profile=False)
    cs = compile_script(parse(RAW_SQL), tables=tables)
    rep = verify_consistency(cs, tables, n_shards=n_shards, bitwise=True,
                             replication=1, kill_shard_at=5, ship_every=7,
                             device=device)
    print(f"raw+kill  (S={n_shards}): {rep}")
    ok &= rep.passed

    tables2 = int_prices(make_action_tables(
        n_actions=120, n_orders=0, n_users=4, horizon_ms=12_000_000,
        seed=13, with_profile=False))
    cs2 = compile_script(parse(PREAGG_SQL), tables=tables2)
    rep2 = verify_consistency(cs2, tables2, use_preagg=True,
                              n_shards=n_shards, bitwise=True,
                              replication=1, kill_shard_at=9,
                              ship_every=5, device=device)
    print(f"preagg+kill(S={n_shards}): {rep2}")
    ok &= rep2.passed

    ok &= _engine_gate(n_shards, device)
    return 0 if ok else 1


if __name__ == "__main__":
    dev, rest = device_argv()
    sys.exit(main(tail_int_argv(rest, 4)[0], device=dev))
