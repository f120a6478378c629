"""Static steady-state memory bound (reconciled with §8.1's model).

Three resident components, all derivable from the lowered plan:

* **store tensors** — per table: ``capacity x (key + ts + value cols)``
  dense int32/float32 columns, the int64 ``comp`` sort key and the 0-d
  int32 ``count`` (``timestore.make_state`` layout), byte-exact against
  a store's tensors (test-enforced);
* **pre-agg planes** — per long window: fine + coarse ring buffers per
  deduplicated leaf plus the two epoch arrays, byte-exact against
  ``PreAgg.init_state()`` (test-enforced);
* **gather buffers** — per window group per in-flight request:
  ``n_sources x buffer + 1`` unit rows across the needed columns.

The dense-array accounting is this port's actual store footprint; the
dense row bytes without ``comp`` (the JAX package's row) fed through
``storage.memest.estimate_memory`` give the paper's §8.1 node-size
model (per-key skiplist overheads included) for capacity planning
against a real OpenMLDB deployment, which does not depend on how this
store lays its tensors out.
"""

from __future__ import annotations

from typing import Dict, Optional

from ...storage.memest import TableMemSpec, estimate_memory
from ..lowering.windows import group_windows

__all__ = ["memory_bound", "preagg_plane_bytes", "COMP_BYTES"]

# the store's int64 composite (key, ts) sort key, one per slot
COMP_BYTES = 8


def preagg_plane_bytes(pa) -> int:
    """Exact resident bytes of one pre-agg plane's state arrays (each
    leaf's identity read for its element count and dtype)."""
    total = 0
    for leaf in pa.leaves.values():
        ident = leaf.identity()
        per = ident.numel() * ident.element_size()
        total += pa.n_keys * (pa.n_fine + pa.n_coarse) * per
    # fine_epoch + coarse_epoch, int32
    total += pa.n_keys * (pa.n_fine + pa.n_coarse) * 4
    return total


def memory_bound(cs, tables=None, capacity: Optional[int] = None,
                 max_batch: int = 64) -> Dict[str, object]:
    """Steady-state footprint from retention/capacity and plan widths.

    Row bounds resolve in evidence order: explicit ``capacity``, else
    table row counts (compile-time tables as fallback), else unbounded
    (``None`` bytes + a hazard).  ``max_batch`` sizes the transient
    gather-buffer term (requests in flight concurrently).  A table's
    ``bytes`` is ``rows x (row_bytes_dense + COMP_BYTES) + 4``: its
    store tensors' ``nbytes``.
    """
    if tables is None:
        tables = cs.ctx.tables
    tables = tables or None        # empty compile-time dict != evidence
    need = cs.required_store_columns()
    hazards = []

    store: Dict[str, Dict[str, object]] = {}
    specs = []
    store_total = 0
    for tname, cols in sorted(need.items()):
        n_cols = len(cols)
        row_bytes = 4 * (n_cols + 2)          # key + ts + value columns
        rows = capacity
        if rows is None and tables is not None and tname in tables:
            rows = len(tables[tname])
        entry = {"value_columns": n_cols, "row_bytes_dense": row_bytes,
                 "rows": rows}
        if rows is None:
            entry["bytes"] = None
            hazards.append(
                f"table {tname!r}: no capacity/retention row bound — "
                f"store growth is unbounded")
        else:
            # + comp per row, + the count scalar
            entry["bytes"] = rows * (row_bytes + COMP_BYTES) + 4
            store_total += entry["bytes"]
        store[tname] = entry
        specs.append(TableMemSpec(name=tname, n_rows=rows or 0,
                                  avg_row_bytes=row_bytes))

    planes: Dict[str, Dict[str, object]] = {}
    plane_total = 0
    for w in cs.windows:
        if w.preagg is None:
            continue
        pa = w.preagg
        b = preagg_plane_bytes(pa)
        plane_total += b
        planes[w.node.spec.name] = {
            "n_keys": pa.n_keys, "fine_slots": pa.n_fine,
            "coarse_slots": pa.n_coarse,
            "leaves": sorted(pa.leaves), "bytes": b,
        }

    gather: Dict[str, Dict[str, object]] = {}
    gather_total = 0
    for members in group_windows(cs.windows):
        w0 = members[0]
        buf = max(m.online_buffer for m in members)
        n_src = len(w0.sources)
        needed = sorted(set().union(*(m.needed_cols for m in members)))
        unit_rows = n_src * buf + 1           # + the request row
        # value cols + ts + valid + rank/perm scratch, 4B lanes
        per_request = unit_rows * 4 * (len(needed) + 3)
        gather[w0.node.spec.name] = {
            "sources": n_src, "buffer_rows": buf,
            "unit_rows": unit_rows,
            "bytes_per_request": per_request,
            "bytes_at_max_batch": per_request * max_batch,
        }
        gather_total += per_request * max_batch

    paper = estimate_memory(specs)
    known = all(e["bytes"] is not None for e in store.values())
    return {
        "store": store,
        "store_bytes": store_total if known else None,
        "preagg_planes": planes,
        "preagg_bytes": plane_total,
        "gather_buffers": gather,
        "gather_bytes_at_max_batch": gather_total,
        "max_batch": max_batch,
        "steady_state_bytes": (store_total + plane_total + gather_total
                               if known else None),
        "paper_model_bytes": paper["__total__"],
        "paper_model_per_table": {k: v for k, v in paper.items()
                                  if k != "__total__"},
        "hazards": hazards,
    }
