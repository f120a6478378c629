"""Cost of one eager step, counted op by op: the port's counterpart of
the reference's ``roofline/hlo_analyzer.py``, which reads XLA's HLO.

The port has no HLO, so ``analyze_step(fn, *args)`` runs ``fn`` once
under a ``TorchDispatchMode`` and counts every aten op it dispatches,
under the reference's conventions:

  * FLOPs — matmul-class ops only (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, ``mv``, ``addmv``, ``dot``: what ``einsum``,
    ``matmul`` and ``linear`` lower to), 2 x |result| x |contracted
    dims|; elementwise FLOPs are ignored, as the reference ignores
    them;
  * HBM bytes — for each materialised op, its result bytes plus its
    operand bytes; views, ``detach`` and other aliasing ops are free,
    as ``bitcast`` and ``get-tuple-element`` are in the reference, and
    so are allocations that write nothing (``empty``).  An in-place
    write at indices into a buffer (``index_put_``: a decode step's
    cache update) moves the values it writes, read and written, and its
    indices, not the whole buffer — the reference's rule for a donated
    ``dynamic-update-slice``.  Eager torch
    materialises every op that XLA would fuse, so this count is larger
    than the reference's fused count by design: it is the traffic of
    the port's own op sequence, not of an ideal schedule;
  * collective bytes — there is no SPMD partitioner: a copy between two
    distinct accelerator devices (``_to_copy`` / ``copy_``) counts its
    max(result, operand) bytes as a ``collective-permute``; a single
    card, or a mesh whose entries repeat one device (``meta`` included),
    gives 0.  Host <-> device copies are not collectives;
  * loops — the eager trace runs every iteration of every Python loop
    (layers, microbatches, KV chunks), so nothing is multiplied after
    the fact: ``loops`` and ``unknown_loops`` are always empty.

The hand-written kernels are loaded with ``ctypes`` or Triton, out of a
dispatch mode's sight.  So each kernel's public op reports its own cost
(its ``ops.cost``: the dot-equivalent FLOPs of its contractions and its
bytes, each input read once and each output written once) through
``kernels.dispatch.kernel_cost``, and the ops it runs meanwhile — the
launch's allocations on the card, the plain version on the CPU, nothing
on ``meta`` — are not counted again.  A kernel's record is therefore the
same on every device, and ``StepCost.kernels`` holds one call per launch
on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import dispatch

__all__ = ["analyze_step", "StepCost", "StepCounter", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# (op, index of the left operand): 2 x |result| x its last dim
_MATMULS = {_aten.mm: 0, _aten.bmm: 0, _aten.mv: 0, _aten.addmm: 1,
            _aten.baddbmm: 1, _aten.addmv: 1}
_DOTS = (_aten.dot, _aten.vdot)
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten._local_scalar_dense,
         _aten.lift_fresh, _aten.detach, _aten.alias, _aten.set_}
_COPIES = {_aten._to_copy: (0, None), _aten.copy_: (1, 0)}
# in-place writes at indices: (index of the indices, index of the values)
_SCATTERS = {_aten.index_put_: (1, 2), _aten._index_put_impl_: (1, 2)}


@dataclasses.dataclass
class StepCost:
    """What one step cost: the reference's ``HloCost`` fields, plus
    ``kernels`` — {kernel name: {"calls", "flops", "bytes"}} from the
    hand-written kernels' own cost records."""

    flops: float
    hbm_bytes: float
    collectives: Dict[str, float]
    loops: List[Tuple[str, int]]
    unknown_loops: List[str]
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def as_dict(self):
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collectives": self.collectives,
            "loops": self.loops,
            "unknown_loops": self.unknown_loops,
        }


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


def _flops(func, args, out) -> float:
    packet = func.overloadpacket
    if packet in _MATMULS:
        lhs = args[_MATMULS[packet]]
        return 2.0 * out.numel() * lhs.shape[-1]
    if packet in _DOTS:
        return 2.0 * args[0].numel()
    return 0.0


def _cross_device(func, args, out) -> bool:
    src_i, dst_i = _COPIES[func.overloadpacket]
    src = args[src_i].device
    dst = out.device if dst_i is None else args[dst_i].device
    return src != dst and src.type != "cpu" and dst.type != "cpu"


class StepCounter(TorchDispatchMode):
    """Counts the ops dispatched inside its ``with`` block and the cost
    records of the kernels called there (see the module docstring);
    ``result()`` is the ``StepCost`` so far."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives = {k: 0.0 for k in COLLECTIVES}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._quiet = 0

    def __enter__(self):
        dispatch.push_cost_sink(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            dispatch.pop_cost_sink(self)

    # -- the kernels' side (kernels.dispatch.kernel_cost) -----------------
    def kernel(self, name: str, cost: dispatch.KernelCost) -> None:
        rec = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                             "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += cost.flops
        rec["bytes"] += cost.nbytes
        self.flops += cost.flops
        self.hbm_bytes += cost.nbytes

    @contextlib.contextmanager
    def quiet(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # -- every aten op ----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        if packet in _FREE or _is_view(func):
            return
        self.flops += _flops(func, args, out)
        if packet in _SCATTERS:
            ix, vals = _SCATTERS[packet]
            nbytes = 2 * _nbytes(args[vals]) + _nbytes(args[ix])
        else:
            nbytes = _nbytes(out) + _nbytes((args, kwargs))
        self.hbm_bytes += nbytes
        if packet in _COPIES and _cross_device(func, args, out):
            src = args[_COPIES[packet][0]]
            self.collectives["collective-permute"] += max(
                _nbytes(out), _nbytes(src))

    def result(self) -> StepCost:
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives.values())
        return StepCost(flops=self.flops, hbm_bytes=self.hbm_bytes,
                        collectives=coll, loops=[], unknown_loops=[],
                        kernels={k: dict(v) for k, v in self.kernels.items()})


def analyze_step(fn: Callable[..., Any], *args, **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once and return what it cost
    (``StepCost``).  On ``meta`` tensors nothing is computed or
    allocated, and the count is the same as on the card."""
    with StepCounter() as counter:
        fn(*args, **kwargs)
    return counter.result()
