"""Static retrace bound: pad classes and what the §4.2 cache can gain.

Every request driver pads its batch to a class, not a request: batch
sizes pad to the next power of two (``drivers.pad_batch``), sharded
sub-batches to powers of two up to 32 then multiples of 32
(``drivers._route``), offline units bucket into power-of-two width
classes.  The classes are the JAX package's.

What they cost differs.  PyTorch runs eagerly, so the port traces and
compiles no executable per class.  Its §4.2 cache (``lowering.cache``,
counted by ``cache_stats()["misses"]``) holds one unit-fold plan per
window group per device (``kernels.unit_fold.ops.plan_for``, keyed by
the group's specs, leaves and member keys), built on the first fused
fold of that group and shared by every driver on that device.  So per
device, with G window groups of the script:

* the fused fold (``fused_unit_fold=True``): ``online``,
  ``online_batch``, ``online_sharded_batch`` and ``offline`` can miss
  at most G times, plus the groups of the raw-served windows alone when
  some windows are pre-aggregated (their groups change when the
  pre-aggregated members leave); ``online_batch_fast`` (always fused,
  every window raw) at most G;
* the staged fold: no driver but ``online_batch_fast`` uses the cache;
* ``preagg_update_many`` runs eager torch ops at any batch size: no
  pad class, no cache entry.

``max_executables`` of a driver counts those misses and
``max_executables_total`` the distinct plans over all drivers (a plan
one driver built is a hit for the next).  The script's per-(store, pad
class) request plans (``drivers.batch_plan``) and its offline plan per
table content (``drivers.plan_offline``) hold these plans and add no
miss.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ...storage.timestore import next_pow2
from ..lowering.windows import group_windows

__all__ = ["retrace_bound", "pow2_classes", "sharded_pad_classes"]


def pow2_classes(max_n: int) -> List[int]:
    """Reachable ``pad_batch`` classes for batch sizes 1..max_n."""
    out, b = [], 1
    top = next_pow2(max(1, max_n))
    while b <= top:
        out.append(b)
        b *= 2
    return out


def sharded_pad_classes(max_batch: int) -> List[int]:
    """Reachable per-shard sub-batch pads: powers of two while <= 32,
    then multiples of 32 (``drivers._route``)."""
    out = [b for b in (1, 2, 4, 8, 16, 32)
           if b <= next_pow2(max(1, min(max_batch, 32)))]
    if max_batch > 32:
        out += list(range(64, ((max_batch + 31) // 32) * 32 + 1, 32))
    return out


def _groups(cs, windows) -> Set[Tuple[int, ...]]:
    """Each window group of ``windows`` as the positions of its members
    in ``cs.windows``: one unit-fold plan each."""
    pos = {id(w): i for i, w in enumerate(cs.windows)}
    return {tuple(pos[id(m)] for m in g) for g in group_windows(windows)}


def retrace_bound(cs, tables=None, max_batch: int = 1024,
                  max_ingest_batch: int = 4096,
                  plan=None) -> Dict[str, object]:
    """Enumerate the pad classes a script can generate and the §4.2
    cache misses each driver can add (module docstring).

    ``max_batch`` bounds the request batch size (the serving loop's
    admission cap); ``max_ingest_batch`` bounds one ``put_many`` /
    binlog-ship batch.  ``plan`` optionally injects the offline
    ``GroupLowering`` list (from ``plan_offline``) for exact unit
    width classes; otherwise the offline entry is data-dependent.
    """
    hazards: List[str] = []
    drivers: Dict[str, Dict[str, object]] = {}

    fused = bool(cs.ctx.fused_unit_fold)
    every = _groups(cs, cs.windows)
    request = set(every)
    if any(w.preagg is not None for w in cs.windows):
        request |= _groups(cs, [w for w in cs.windows if w.preagg is None])
    # the plans each driver can build, per device
    plans = {"online": request if fused else set(),
             "online_batch_fast": every,
             "offline": every if fused else set()}
    fold = ("fused fold: one unit-fold plan per window group"
            if fused else "staged fold: no cached plan")
    per_device = "per device, shared with every other driver"

    batch_classes = pow2_classes(max_batch)
    drivers["online"] = {
        "pad_classes": [1], "max_executables": len(plans["online"]),
        "bounded": True,
        "note": f"{fold} ({len(plans['online'])}) {per_device}",
    }
    drivers["online_batch"] = {
        "pad_classes": batch_classes,
        "max_executables": len(plans["online"]), "bounded": True,
        "note": f"{fold} ({len(plans['online'])}) {per_device}; the "
                f"{len(batch_classes)} pad classes add none",
    }
    fast_ok, fast_why = cs.fast_batch_eligible()
    drivers["online_batch_fast"] = {
        "eligible": fast_ok, "reason": fast_why,
        "pad_classes": batch_classes if fast_ok else [],
        "max_executables": len(every) if fast_ok else 0,
        "bounded": True,
        "note": f"always the fused fold: one unit-fold plan per window "
                f"group ({len(every)}) {per_device}",
    }
    shard_ok, shard_why = cs.sharded_eligible()
    s_classes = sharded_pad_classes(max_batch) if shard_ok else []
    drivers["online_sharded_batch"] = {
        "eligible": shard_ok, "reason": shard_why,
        "pad_classes": s_classes,
        "max_executables": len(plans["online"]) if shard_ok else 0,
        "bounded": True,
        "note": f"{fold} ({len(plans['online']) if shard_ok else 0}) "
                f"{per_device}; the sub-batch pads add none",
    }
    if shard_ok and max_batch > 32:
        hazards.append(
            f"online_sharded_batch pad classes grow LINEARLY in the "
            f"per-shard sub-batch beyond 32 ({len(s_classes)} classes "
            f"at max_batch={max_batch}): cap admission batches or "
            f"shard count x 32 to stay logarithmic")

    # ---- offline: unit width classes per window group
    n_off = len(plans["offline"])
    off_note = (f"{fold} ({n_off}) {per_device}; the unit blocks and "
                f"width classes add none")
    if plan is not None:
        width = sorted({b.idx.shape[1] for gl in plan
                        for b in gl.blocks})
        n_blocks = sum(len(gl.blocks) for gl in plan)
        drivers["offline"] = {
            "unit_width_classes": width,
            "max_executables": n_off,
            "bounded": True,
            "note": f"{off_note}: {n_blocks} unit blocks over width "
                    f"classes {width}",
        }
    else:
        drivers["offline"] = {
            "unit_width_classes": None,
            "max_executables": n_off, "bounded": tables is not None,
            "note": f"{off_note}; unit width classes are data-derived "
                    f"(pow2 >= 16, bounded <2x by §6.2 slicing); pass "
                    f"tables for the exact class list",
        }
        if tables is None:
            hazards.append(
                "offline unit width classes unknown without table "
                "statistics (bounded per signature, but each new table "
                "signature re-plans)")

    # ---- pre-agg ingest folds: eager ops, no class, no cached program
    n_pre = sum(1 for w in cs.windows if w.preagg is not None)
    drivers["preagg_update_many"] = {
        "pad_classes": [],
        "max_executables": 0,
        "bounded": True,
        "note": f"{n_pre} pre-agg plane(s) folded by eager torch ops at "
                f"any ingest batch size (up to {max_ingest_batch}): no "
                f"pad class, no cached plan",
    }

    hazards.append(
        "per STORE IDENTITY bound: a new/grown store or a changed "
        "capacity re-keys every online class; a new table content "
        "signature re-keys the offline plan")
    total = len(set().union(*plans.values()))
    return {
        "max_batch": max_batch,
        "max_ingest_batch": max_ingest_batch,
        "drivers": drivers,
        "max_executables_total": total,
        "bounded": all(bool(d.get("bounded")) for d in drivers.values()),
        "hazards": hazards,
    }
