"""CI gate of the PyTorch port: offline vs online replay consistency,
sharded + bitwise (the port's counterpart of ``check_consistency.py``).

Runs ``repro_torch.core.verify_consistency`` on small synthetic
workloads with BOTH executors sharded — offline through
``CompiledScript.offline_sharded`` and online through the key-sharded
serving path — with pre-aggregation off and on, on ``--device`` (the
card unless ``--device cpu``).

The raw gates ALWAYS assert ``array_equal`` on every feature INCLUDING
floats (both executors run the same unit fold core over the same rows).
``--bitwise`` additionally runs a pre-agg gate on integer-valued prices,
where bucket-partial re-bracketing is float-exact, asserting
``array_equal`` there too, and the raw gate with the fused unit fold
(the unit-fold kernel on the card) driving both executors.  The
float-price pre-agg gate stays at reduction-order tolerance.

    PYTHONPATH=src python tools/torch_check_consistency.py [--bitwise] \\
        [--device cpu] [n_shards]
"""

from __future__ import annotations

import sys

try:
    from tools.torch_common import (PREAGG_SQL, RAW_SQL, device_argv,
                                    int_prices, tail_int_argv)
except ImportError:                      # invoked as `python tools/x.py`
    from torch_common import (PREAGG_SQL, RAW_SQL, device_argv, int_prices,
                              tail_int_argv)

from repro_torch.core import compile_script, parse, verify_consistency  # noqa
from repro_torch.data.synthetic import make_action_tables  # noqa: E402


def main(n_shards: int = 4, bitwise: bool = False,
         device: str = "cuda") -> int:
    ok = True
    tables = make_action_tables(n_actions=150, n_orders=0, n_users=6,
                                seed=11, with_profile=False)
    cs = compile_script(parse(RAW_SQL), tables=tables)
    rep = verify_consistency(cs, tables, n_shards=n_shards, bitwise=True,
                             device=device)
    print(f"raw       (S={n_shards}): {rep}")
    ok &= rep.passed

    # unsharded raw path through the same bitwise gate (same compiled
    # script: the plan caches carry over)
    rep_u = verify_consistency(cs, tables, bitwise=True, device=device)
    print(f"raw       (S=1): {rep_u}")
    ok &= rep_u.passed

    tables2 = make_action_tables(n_actions=120, n_orders=0, n_users=4,
                                 horizon_ms=12_000_000, seed=12,
                                 with_profile=False)
    cs2 = compile_script(parse(PREAGG_SQL), tables=tables2)
    rep2 = verify_consistency(cs2, tables2, use_preagg=True,
                              n_shards=n_shards, device=device)
    print(f"preagg    (S={n_shards}): {rep2}")
    ok &= rep2.passed

    if bitwise:
        tables3 = int_prices(make_action_tables(
            n_actions=120, n_orders=0, n_users=4,
            horizon_ms=12_000_000, seed=13, with_profile=False))
        cs3 = compile_script(parse(PREAGG_SQL), tables=tables3)
        rep3 = verify_consistency(cs3, tables3, use_preagg=True,
                                  n_shards=n_shards, bitwise=True,
                                  device=device)
        print(f"preagg-int(S={n_shards}): {rep3}")
        ok &= rep3.passed

        # the fused unit fold (the unit-fold kernel on the card) driving
        # BOTH executors (offline blocks + online fast path) through the
        # same bitwise gate
        cs_f = compile_script(parse(RAW_SQL), tables=tables,
                              fused_unit_fold=True)
        rep_f = verify_consistency(cs_f, tables, n_shards=n_shards,
                                   bitwise=True, device=device)
        print(f"raw-fused (S={n_shards}): {rep_f}")
        ok &= rep_f.passed
    return 0 if ok else 1


if __name__ == "__main__":
    dev, rest = device_argv()
    n, flags = tail_int_argv(rest, 4, "--bitwise")
    sys.exit(main(n, bitwise=flags["bitwise"], device=dev))
