"""Static plan certifier CLI of the PyTorch port:
``python -m tools.torch_analyze_plan <script>`` (the port's counterpart
of ``analyze_plan.py``).

Compiles a feature script, runs the static analyzer
(``repro_torch.core.analysis.certify``), and prints the deployment
certificate — per-column consistency class, retrace bound, shard
eligibility reason tree, and the steady-state memory bound — without
executing the plan on a single request.

``<script>`` is either a ``.sql`` file or a ``.py`` module with a
module-level ``SQL`` constant (the examples/ convention: the reference's
``examples/*.py`` and the port's ``examples/torch_*.py`` alike), read
statically — the module is never imported.  Synthetic tables sized to
the script's features supply the data statistics that discharge the
data-dependent rules; ``--no-tables`` certifies from the plan alone
(strictly more conservative).

``--cross-check`` additionally replays the script through
``verify_consistency(bitwise=True)`` on ``--device`` (the card unless
``--device cpu``) and enforces the certifier's contract: every column
the certificate calls BITWISE must be observed bitwise-equal
dynamically (the converse is allowed — static tolerance is a
non-promise, not a prediction of inequality).

    PYTHONPATH=src python -m tools.torch_analyze_plan \\
        examples/torch_quickstart.py --cross-check --device cpu \\
        --json certs/CERT_torch_quickstart.json
"""

from __future__ import annotations

import argparse
import ast
import pathlib
import sys

try:
    from tools.torch_common import int_prices  # noqa: F401  (re-export)
except ImportError:                      # invoked as `python tools/x.py`
    from torch_common import int_prices  # noqa: F401

from repro_torch.core import compile_script, parse, verify_consistency
from repro_torch.core.analysis import certify
from repro_torch.data.synthetic import make_action_tables


def load_sql(path: pathlib.Path) -> str:
    """Extract the script: raw ``.sql``, or the ``SQL`` constant of a
    ``.py`` module (parsed statically — the module is never imported)."""
    text = path.read_text()
    if path.suffix != ".py":
        return text
    for node in ast.parse(text).body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "SQL"
                        for t in node.targets)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            return node.value.value
    raise SystemExit(f"torch_analyze_plan: no module-level SQL constant "
                     f"in {path}")


def synthetic_tables(sql: str, n_actions: int = 150, seed: int = 11):
    """Tables shaped to the script: long horizon iff it pre-aggregates,
    orders/profile only when the script reads them."""
    horizon = 12_000_000 if "long_windows" in sql else 60_000
    return make_action_tables(
        n_actions=n_actions,
        n_orders=n_actions // 2 if "orders" in sql else 0,
        n_users=6, horizon_ms=horizon, seed=seed,
        with_profile="profile" in sql)


def cross_check(cert, cs, tables, device: str = "cuda") -> int:
    """Enforce conservative agreement; returns the number of failures.

    Under ``bitwise=True`` the report's ``mismatched`` list is exactly
    the non-bitwise columns, so the check is column-exact: every column
    the certificate marks bitwise must be absent from it.
    """
    failures = 0
    for mode, use_preagg in (("raw", False), ("preagg", True)):
        if use_preagg and not any(w.preagg for w in cs.windows):
            continue
        rep = verify_consistency(cs, tables, use_preagg=use_preagg,
                                 bitwise=True, device=device)
        not_bitwise = set(rep.mismatched)
        for col, entry in cert.consistency["columns"].items():
            if entry[mode] == "bitwise" and col in not_bitwise:
                print(f"cross-check: FAIL {mode} column {col!r}: "
                      f"certified bitwise, observed tolerance-only")
                failures += 1
        n_static = sum(e[mode] == "bitwise"
                       for e in cert.consistency["columns"].values())
        print(f"cross-check: {mode}: {n_static} certified-bitwise "
              f"columns, {len(not_bitwise)} dynamically non-bitwise "
              f"({sorted(not_bitwise)})")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_analyze_plan", description=__doc__.splitlines()[0])
    ap.add_argument("script", help=".sql file or .py with SQL constant")
    ap.add_argument("--json", metavar="OUT",
                    help="also write the certificate JSON here")
    ap.add_argument("--cross-check", action="store_true",
                    help="replay through verify_consistency and enforce "
                         "conservative agreement")
    ap.add_argument("--no-tables", action="store_true",
                    help="certify from the plan alone (conservative)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="store capacity bound for the no-tables case")
    ap.add_argument("--n-actions", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="where --cross-check replays (cuda or cpu)")
    args = ap.parse_args(argv)

    sql = load_sql(pathlib.Path(args.script))
    tables = None if args.no_tables else synthetic_tables(
        sql, n_actions=args.n_actions)
    cs = compile_script(parse(sql), tables=tables)
    cert = certify(cs, tables=tables, capacity=args.capacity)

    print(cert.summary())
    if args.json:
        out = pathlib.Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(cert.to_json() + "\n")
        print(f"certificate -> {out}")

    if args.cross_check:
        if tables is None:
            raise SystemExit("torch_analyze_plan: --cross-check needs "
                             "tables (drop --no-tables)")
        failures = cross_check(cert, cs, tables, args.device)
        if failures:
            return 1
        print("cross-check: certificate is conservative-consistent with "
              "the dynamic gate")
    return 0


if __name__ == "__main__":
    sys.exit(main())
