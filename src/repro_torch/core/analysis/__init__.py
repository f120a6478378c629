"""Static plan certifier (deploy-time analysis, no data execution).

``certify(cs, tables=...)`` consumes a ``CompiledScript``'s lowered plan
— window groups, leaf programs, §6.2 unit plans, join resolution — and
emits a machine-readable :class:`DeploymentCertificate` proving four
properties *before any request is served*:

* **consistency classification** — per output column, bitwise vs
  tolerance-only, by walking the same degradation rules
  ``docs/architecture.md`` states in prose (rule IDs ``C-*``);
* **retrace bound** — the pad/shape classes each driver can generate,
  and the §4.2 cache misses (unit-fold plans) each can add, with
  unbounded-growth hazards;
* **shard eligibility** — a structured reason tree for
  ``online_sharded_batch`` acceptance (rule IDs ``S-*``);
* **static memory bound** — steady-state store + pre-agg-plane +
  gather-buffer footprint, byte-exact against the store's and the
  planes' tensors, reconciled with ``storage.memest``.

Host code: it reads the plan and numpy table columns, never a device.

The certificate is *conservative, never optimistic*: a column it
certifies ``bitwise`` must pass ``verify_consistency(bitwise=True)``;
a ``tolerance`` classification makes no bitwise promise (the dynamic
gate may still observe equality, e.g. integer-valued float inputs).
"""

from .certificate import DeploymentCertificate, certify  # noqa: F401
from .consistency_rules import (CONSISTENCY_RULES,  # noqa: F401
                                classify_consistency)
from .memory import memory_bound  # noqa: F401
from .retrace import retrace_bound  # noqa: F401
from .sharding import SHARDING_RULES, explain_sharding  # noqa: F401

__all__ = [
    "DeploymentCertificate", "certify", "classify_consistency",
    "retrace_bound", "explain_sharding", "memory_bound",
    "CONSISTENCY_RULES", "SHARDING_RULES",
]
