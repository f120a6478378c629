"""Plan lowering: one IR -> the fused online executor.

* ``windows``  — static window lowering, grouping, and the batched
                 scatter-merge unit gather feeding the fused unit fold;
* ``joins``    — LAST JOIN resolution against the pre-ranked store;
* ``scalars``  — scalar select-item evaluation and output assembly;
* ``drivers``  — the fused batched request driver;
* ``cache``    — the plan cache shared by every driver.
"""

from . import cache, drivers, joins, scalars, windows  # noqa: F401
