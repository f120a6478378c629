"""Shard-eligibility explanation (rule IDs ``S-*``).

``CompiledScript.sharded_eligible()`` is a bare boolean + first-failure
string; deployment tooling needs the full reason tree — which checks
ran, which passed, and what exactly disqualifies a script from the
key-sharded serving path.  The tree mirrors the driver's guard exactly
(``explain_sharding(cs)["eligible"] == cs.sharded_eligible()[0]`` is
test-enforced), so the explanation can never drift from the gate.
"""

from __future__ import annotations

from typing import Dict

SHARDING_RULES: Dict[str, str] = {
    "S-PART-EXISTS": "the script has at least one window partition "
                     "column to route keys by",
    "S-PART-SINGLE": "all windows partition by ONE column (a single "
                     "routing key per request)",
    "S-JOIN-ALIGNED": "every LAST JOIN keys on the partition column "
                      "(join rows co-locate with their requests)",
}

__all__ = ["SHARDING_RULES", "explain_sharding"]


def explain_sharding(cs) -> Dict[str, object]:
    """Structured reason tree for ``online_sharded_batch`` acceptance."""
    part = sorted({w.node.spec.partition_by for w in cs.windows})
    checks = []
    checks.append({
        "rule": "S-PART-EXISTS", "ok": bool(part),
        "detail": (f"windows partition by {part}" if part
                   else "no window partition column to shard by"),
    })
    checks.append({
        "rule": "S-PART-SINGLE", "ok": len(part) == 1,
        "detail": (f"single routing key {part[0]!r}" if len(part) == 1
                   else f"{len(part)} distinct partition columns "
                        f"{part}: one request cannot route to one "
                        f"shard"),
    })
    for js in cs.script.last_joins:
        ok = js.left_key in part
        checks.append({
            "rule": "S-JOIN-ALIGNED", "ok": ok,
            "table": js.right_table,
            "detail": (f"LAST JOIN {js.right_table!r} keys on "
                       f"{js.left_key!r}"
                       + ("" if ok else
                          f", not the partition column {part}: join "
                          f"rows would land on a different shard than "
                          f"their requests")),
        })
    eligible = all(c["ok"] for c in checks)
    failed = [c for c in checks if not c["ok"]]
    return {
        "eligible": eligible,
        "checks": checks,
        "first_failure": failed[0]["rule"] if failed else None,
        "driver_reason": cs.sharded_eligible()[1],
    }
