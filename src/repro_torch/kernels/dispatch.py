"""Kernel dispatch policy — one place deciding kernel vs plain version.

* ``use_kernel=None`` follows the tensor: a CUDA tensor launches the
  hand-written kernel, a CPU tensor runs the plain PyTorch version;
* ``use_kernel=True`` forces the kernel, and raises
  :class:`KernelUnsupportedError` for a tensor that is not on a CUDA
  device (there is no fallback: a kernel that cannot run is an error);
* ``use_kernel=False`` runs the plain version wherever the tensor lies
  (the reference the kernels are held against).

Every kernel wrapper counts its launches here, one per launch and
nowhere else, so a run can show that its main path went through the
kernels.  ``resolve_device`` is the entry points' side of the policy:
they run on the card unless the caller asks for the CPU, and a CUDA
device without a card raises (no silent move to the CPU).

Every kernel's ``ops.py`` also has a ``cost(...)`` function: the bytes
its call must move (each input read once, each output written once),
the operations its bound counts, and the dot-equivalent FLOPs of its
contractions (``KernelCost``).  ``chip_smoke.py`` takes each kernel's
bound from it, and the public op reports it through ``kernel_cost`` to
the step counter of ``roofline.trace_analyzer`` when one is active
(``push_cost_sink``), on every route: the kernel on the card, the plain
version on the CPU, and the shape-only branch a wrapper takes for
tensors on the ``meta`` device.  The ops the wrapper runs meanwhile are
not counted again.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional

import torch

__all__ = ["KernelUnsupportedError", "resolve", "resolve_device",
           "count_launch", "launch_counts", "reset_launch_counts",
           "KernelCost", "kernel_cost", "push_cost_sink", "pop_cost_sink",
           "is_meta"]

_LAUNCHES: Dict[str, int] = {}
_COST_SINKS: List[Any] = []


class KernelCost(NamedTuple):
    """One kernel call's least work: ``nbytes`` (each input read once,
    each output written once), ``ops`` (the operations its bound counts,
    at the f32 rate) and ``flops`` (the dot-equivalent FLOPs of its
    contractions, 2 per multiply-add; 0 for a kernel without one)."""

    nbytes: int
    ops: int
    flops: int


class KernelUnsupportedError(RuntimeError):
    """A hand-written CUDA/Triton kernel was forced on a tensor that is
    not on a CUDA device.  Raised at dispatch time, before any launch."""


def resolve(use_kernel: Optional[bool], tensor: torch.Tensor) -> bool:
    """True when the kernel runs for ``tensor``, False for the plain
    version (see the module docstring for the policy)."""
    on_cuda = tensor.device.type == "cuda"
    if use_kernel is None:
        return on_cuda
    if use_kernel and not on_cuda:
        raise KernelUnsupportedError(
            f"use_kernel=True requests the CUDA kernel, but the input lies "
            f"on '{tensor.device}'. Pass use_kernel=None to follow the "
            f"tensor's device, or use_kernel=False for the plain PyTorch "
            f"version.")
    return bool(use_kernel)


def resolve_device(device) -> torch.device:
    """An entry point's device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available; pass device='cpu' to run the "
                           f"plain versions on the CPU")
    return dev


def count_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def is_meta(tensor: torch.Tensor) -> bool:
    """True for a tensor on the ``meta`` device: a wrapper then returns
    outputs of the right shape and dtype and launches nothing."""
    return tensor.device.type == "meta"


def push_cost_sink(sink) -> None:
    """Make ``sink`` (an object with ``kernel(name, cost)`` and a
    ``quiet()`` context manager) the receiver of ``kernel_cost``."""
    _COST_SINKS.append(sink)


def pop_cost_sink(sink) -> None:
    if not _COST_SINKS or _COST_SINKS[-1] is not sink:
        raise RuntimeError("cost sinks popped out of order")
    _COST_SINKS.pop()


@contextlib.contextmanager
def kernel_cost(name: str, cost: Optional[KernelCost]):
    """Report one call of kernel ``name`` to the active step counter, and
    keep the ops run inside the block (the launch's allocations, or the
    plain version) out of its count.  Without a counter, or with ``cost``
    None (a call on empty inputs, which launches nothing), it does
    nothing."""
    if not _COST_SINKS or cost is None:
        yield
        return
    sink = _COST_SINKS[-1]
    sink.kernel(name, cost)
    with sink.quiet():
        yield
