"""Deployment certificate: the four static sections in one artifact."""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from .consistency_rules import (BITWISE, CONSISTENCY_RULES,
                                classify_consistency)
from .memory import memory_bound
from .retrace import retrace_bound
from .sharding import SHARDING_RULES, explain_sharding

__all__ = ["DeploymentCertificate", "certify"]


@dataclasses.dataclass
class DeploymentCertificate:
    """Machine-readable deploy-time proof sheet for one compiled script.

    Built by :func:`certify` without executing the plan on any data —
    only host-side inspection of the lowered IR plus (optional) table
    statistics; nothing runs on a device.  ``to_json()`` is the CI artifact format
    (``CERT_<name>.json``); ``summary()`` is the human rendering.
    """

    fingerprint: str
    features: list
    consistency: Dict[str, object]
    retrace: Dict[str, object]
    sharding: Dict[str, object]
    memory: Dict[str, object]
    rules: Dict[str, str] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------ queries
    def column_class(self, column: str, mode: str = "raw") -> str:
        """``"bitwise"`` | ``"tolerance"`` for one output column under
        ``mode`` in {"raw", "preagg"}."""
        return self.consistency["columns"][column][mode]

    def bitwise_columns(self, mode: str = "raw"):
        return [c for c, e in self.consistency["columns"].items()
                if e[mode] == BITWISE]

    # -------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, object]:
        return {
            # the certificate format's name: the JAX package's certifier
            # writes the same sections and keys
            "certificate": "repro.core.analysis",
            "fingerprint": self.fingerprint,
            "features": self.features,
            "consistency": self.consistency,
            "retrace": self.retrace,
            "sharding": self.sharding,
            "memory": self.memory,
            "rules": self.rules,
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def summary(self) -> str:
        c = self.consistency
        lines = [f"deployment certificate  [{self.fingerprint[:12]}]"]
        lines.append(
            f"  consistency : raw="
            f"{'BITWISE' if c['raw_bitwise'] else 'tolerance'} "
            f"preagg={'BITWISE' if c['preagg_bitwise'] else 'tolerance'}"
            f" (evidence: {c['evidence']})")
        for name, e in c["columns"].items():
            flags = sorted({h["rule"] for h in e["rules"]})
            lines.append(
                f"    {name:<24} raw={e['raw']:<9} "
                f"preagg={e['preagg']:<9}"
                + (f" {flags}" if flags else ""))
        r = self.retrace
        lines.append(
            f"  retrace     : <= {r['max_executables_total']} "
            f"cached fold plans per device at max_batch={r['max_batch']} "
            f"({'bounded' if r['bounded'] else 'UNBOUNDED'})")
        s = self.sharding
        lines.append(
            f"  sharding    : "
            f"{'eligible' if s['eligible'] else 'NOT eligible'}"
            + (f" ({s['first_failure']})" if s["first_failure"]
               else ""))
        m = self.memory
        ss = m["steady_state_bytes"]
        lines.append(
            f"  memory      : steady state "
            f"{'unbounded' if ss is None else f'{ss / 1e6:.2f} MB'}"
            f" (paper §8.1 model {m['paper_model_bytes'] / 1e6:.2f} MB)")
        for h in (r["hazards"] + m["hazards"]):
            lines.append(f"  hazard      : {h}")
        return "\n".join(lines)


def certify(cs, tables=None, capacity: Optional[int] = None,
            max_batch: int = 1024, max_ingest_batch: int = 4096
            ) -> DeploymentCertificate:
    """Build the deployment certificate for one ``CompiledScript``.

    ``tables`` (defaulting to the compile-time tables on ``cs.ctx``)
    supplies the statistics that discharge data-dependent rules AND
    lets the §6.2 unit plan be consulted for the exact slice counts /
    unit width classes; ``capacity`` bounds per-key history by store
    size when tables are absent.
    """
    if tables is None:
        tables = cs.ctx.tables
    tables = tables or None        # empty compile-time dict != evidence

    plan = n_sliced = None
    if tables is not None:
        try:
            from ..lowering.drivers import plan_offline
            plan, _, _ = plan_offline(cs, tables)
            n_sliced = [gl.n_sliced_units for gl in plan]
        except (KeyError, ValueError):
            plan = n_sliced = None     # partial tables: stay conservative

    return DeploymentCertificate(
        fingerprint=cs.fingerprint,
        features=list(cs.feature_names),
        consistency=classify_consistency(cs, tables=tables,
                                         capacity=capacity,
                                         n_sliced_per_group=n_sliced),
        retrace=retrace_bound(cs, tables=tables, max_batch=max_batch,
                              max_ingest_batch=max_ingest_batch,
                              plan=plan),
        sharding=explain_sharding(cs),
        memory=memory_bound(cs, tables=tables, capacity=capacity),
        rules={**CONSISTENCY_RULES, **SHARDING_RULES},
    )
